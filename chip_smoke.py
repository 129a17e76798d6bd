#!/usr/bin/env python3
"""chip_smoke.py — the PyTorch/CUDA port's main path on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--scale 1.0] [--phases kernels,main,...]

It needs a CUDA card and exits non-zero, printing no result, without one
(or without the ``hyperspace_tpu_torch`` package beside it).
``--phases`` takes a comma list of ``kernels``, ``main``, ``aggregate``,
``resident``, ``join``, ``serve``, ``native``, ``front_end``,
``lifecycle``, ``hybrid``, ``reliability``, ``mesh``, ``fabric``,
``streaming`` and ``lint`` (default: all, in that order; aggregate, resident, join,
serve, native and front_end run in the main path's session and bring
``main``, as does fabric, which serves the main path's li_idx). Every query runs through the
whole-plan compiler (``hyperspace.compile.mode`` defaults to ``auto``):
its launches are the interpreter's, N = 1 counts land under
``compile.fused.*``. Phases:

1. header — the card's name and power limit (``nvidia-smi``); the CUDA
   kernels build from ``hyperspace_tpu_torch/csrc`` while g++ builds the
   native IO runtime from ``hyperspace_tpu_torch/native/tcb_io.cc``
   (both timed as set-up; the host's CPU count and model printed), and
   ``ptxas -v``'s registers, static shared memory, stack frame and
   spills per kernel (each of K2p's vpw instantiations apart);
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
   and is timed at li_hy's shape; K2p (K2 over FoR-packed right keys)
   runs at the join region's shape (lineitem's order keys in index
   layout against orders' sorted keys packed in blocks of 128) under its
   group plan for the card and under the minimal window capacity, on its
   edge cases at vpw 2, 4, 8, 16 and 32 (runs of equal keys across a line
   and across a block, keys on fences, an all-pad tail) and on its region
   cases (``k2p_region_cases``: index layouts over 64 and 80 buckets at
   vpw 2 and 4, spans of 64, wide and span-0 tiles interleaved, duplicate
   runs across lines and blocks, a ragged right side) under three group
   plans each (the card's target, a target of 4, the minimal capacity),
   held against its plain version on every padded row and timed beside
   raw K2 over the same codes and ``torch.searchsorted`` x2; the torch epilogue of the
   resident Q17 aggregate (``index_add_`` over 200,000 slots) is timed
   alone and held against numpy; K1b (N programs in one launch) runs N =
   1, 2, 16, 64 and 300, depths 1 to 9 in one batch, packed planes of
   every width beside raw and f64 planes, rows ending mid-word, 40 raw
   planes and a 2^20-row window, and K1hb no mask, all rows deleted and
   random deletions; both run the cases aimed at their range test
   (``ops/k1b_cases.py``) under every sub-tile and ring, and are timed at
   the serving bursts' shapes (B1, B2, L2, L3's window, the hybrid burst)
   over the index layout the bursts serve, in key order and shuffled,
   beside the N single launches they replace;
3. main path — TPC-H-shaped data at scale factor 1 (lineitem 6,001,215
   rows, orders 1,500,000, made with numpy from ``--seed`` and written as
   avro), two covering indexes with 200 buckets built in memory on the
   card, then a point lookup, a range filter and a Q3-shaped join with
   Hyperspace enabled and residency off (the per-file scan: the files'
   columns load through the native runtime's parallel ``pread``, Q3's
   ranges from K2 expand and gather in its C++). The point lookup runs
   under the per-query profiler (conf ``hyperspace.tpu.profile.dir``): its
   Chrome trace must name ``hs_predicate_mask`` and K1's device function,
   and its bytes and kernel names are printed. Every result
   must equal a plain numpy evaluation of the same query, ``explain`` must
   show the index scans, and K1 and K2 must have launched; then, in the
   same session, the aggregates: Q17's shape (lineitem joined to orders,
   grouped by part: the join's match ranges from K2 fused into the
   aggregate by the native single-pass arm), the Q3 join grouped by (order
   key, order date) as TPC-H Q3 ends (keys on both sides: the join is
   materialized through the C++ gather, then hash-aggregated), Q1's shape (the range filter's order-key and
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
5. join — in the same session, residency ``auto``: Q17's shape (J1) runs
   once on the host arm (its ranges from the ranges cache where the
   aggregate phase ran it; else the presorted route, K2 once, no argsort),
   which schedules the join region of li_idx and ord_idx; then 10 warm
   calls through the resident fused aggregate (one K2p launch each, no
   upload). The unfiltered join of lineitem to orders (J2, 6,001,215 rows)
   runs once on the host arm with residency off, then warm through the
   resident materializing join (one K2p launch each, the gather on the
   host). The main path's Q3 (J3, filtered sides) declines residency and
   hits the groups and setup caches on its repeat. J1 and J2 run again with
   ``hyperspace.residency.forDelta`` off from a reset cache: raw right
   codes, one K2 launch a warm call. Each query's seconds, the region's
   build seconds and MB (packed and raw), and ``join_region_key``'s time
   are printed; every result equals numpy. J2's host arm and J3 take
   their ranges from K2 on a first run (the setup cache emptied before),
   from the ranges cache on a repeat;
5a. serve — in the same session, residency ``auto``, li_idx's five
   columns prefetched: the resident phase's 30 queries twice through the
   compiled pipelines (the second round with fresh literals must hit the
   pipeline cache 30 times; one K1c launch a query), two group-bys on the
   card (``agg_scan``: A3's Q1 shape and Q17's inner aggregate over
   lineitem, 200,000 slots; one K1 launch each, the mask and the epilogue
   timed apart), then three bursts through a paused ``QueryServer``: B1 64
   point lookups (one K1b launch, N = 64), B2 16 range filters (one K1b
   launch, N = 16), B3 8 copies of J1 (one join-aggregate dispatch); every
   ticket equals numpy and the same query's ``collect()``;
5b. native — in the same session: each entry of the native runtime at
   the main path's sizes (``hs_pread_many`` over li_idx's 200 files, then
   the 400-file read with its bytes and resident growth, in the page cache
   and, where the host can evict them, out of it, ``read_batches``
   choosing mmap and pread; J2's
   ``hs_expand_gather`` and ``hs_expand_pairs`` over 6,001,215 pairs;
   A1's ``hs_group_agg_ranges_f64``/``_i64`` into 200,000 slots;
   ``hs_write_file_atomic`` of one index file), timed against its plain
   version (the port's numpy arm of the step) and held against it bit for
   bit; the SF3 walk (``hs_smj_ranges``) is the streaming phase's;
6. front end — in the same session, residency off: Q3 written the
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
7. lifecycle — in a session of its own with lineage on: the same rows
   (the main path's files copied) as ``src/lineitem_lc`` (8 avro files) and ``src/orders_lc``
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
8. hybrid — in a session of its own with hybrid scan and lineage on: the
   same rows (the main path's files copied) as ``src/lineitem_hy`` (8 files) and
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
   of the appended files); at H2 a burst of 16 range filters through a
   paused ``QueryServer`` then launches K1hb once for the batch; after
   H4's refresh no delta is left;
9. reliability — in a session of its own with a 2 s writer lease: li_rel
   and ord_rel (200 buckets) over the main path's avro source. R1 a create
   killed at its final log entry (fault file system), rolled back by the
   next session's listing once its lease expires, the doctor's torn
   version directory vacuumed, the create again, the range filter and Q3
   against numpy; R2 a full refresh with every log call failing once
   under the retry layer (retries = faults); R3 a stalled delete fenced
   by a forced cancel (LeaseFencedError); R4 the device probe; R5 B1's 64
   point lookups through a paused one-worker server whose batched launch
   raises once: every ticket answered through K1 per file, the server
   degraded and the table dropped, then a fresh server with one K1b
   launch. A ``reliability:`` JSON line gives each step's seconds, the
   counters, the doctor's issue kinds, the probe's ms and the launches.
   Every other phase but mesh ends with its device-loss degrade counters
   (``scan.resident.device_failed``, ``scan.resident_join.device_failed``,
   ``residency.stream.window_failed``, ``serve.degraded``,
   ``shuffle.device_failed``) at 0;
9a. mesh — in a session of its own with ``make_mesh(4, device="cuda:0")``
   (4 shards on one card: the sharded code paths, the per-shard K1 and K2
   launches and the exchange run on the card, no traffic between cards)
   and residency off, over the main path's avro source: M1 the sharded
   build of li_mesh and ord_mesh (200 buckets) and ord_m64 (64), every file
   of li_mesh and ord_mesh equal to the single-device build's byte for
   byte (the footer's index name aside), and li_mesh_st through the
   streaming build's mesh arm; M2 the range filter (one K1 a shard) and a
   point lookup under ``hyperspace.tpu.distributedQuery.minRows`` (no K1);
   M3 the co-partitioned Q3 (K2 and K2F once a shard); M4 A3's Q1 shape as
   a two-phase aggregate (one K1 a shard); M5 Q3 against ord_m64, the
   orders side moved into the 200-bucket space in one all_to_all round
   (K2 and K2F once a shard, M3's rows in order); M6 M5 with the exchange
   raising on its first call (``shuffle.device_failed`` = 1, the exact join
   once on the card). A ``mesh:`` JSON line gives each step's seconds,
   launches and counters, the shards and the phase's peak device memory;
9b. fabric — the multi-controller tier over the main path's li_idx and
   lineitem: F1 two worker processes (this script with
   ``--fabric-worker``), each one contiguous half of lineitem with
   l_shipmode (TPC-H's 7 values, drawn from the seed) handed over as npz
   files, join one gloo group through a ``file://`` store and build it
   through ``QueryFabric.build_sharded`` on 2 shards each of the card (D =
   4; the exchange staged through pinned host memory, the vocabulary
   union on shared storage), each writing only its own buckets' files;
   counts, each bucket's rows and each file's key order are held against
   the parent's ``build_partition_sharded`` over the whole table. F2-F6:
   two hosts, sessions with residency forced over li_idx, each with a
   ``QueryServer``, fronted by a ``QueryRouter`` (``make_router``), host i
   taking half i of l_orderkey: F2 A3's Q1 shape (one K1 a host leg, the
   merged groups equal the single session's and numpy's), F3 the range
   filter (one K1c a host leg), F4 64 identical lookups coalesced onto one
   fan-out and B1's 64 distinct ones (one K1b a host, N = 64), F5 chaos
   (a crash with 0 failed tickets, a slow host hedged, a flapping host
   readmitted through a probation probe, ``revive_host``), F6 the fleet
   result cache (a hit with zero legs) and warm-compile hints. A
   ``fabric:`` JSON line gives each step's seconds, launches and counters;
10. streaming — in a session of its own with lineage on: TPC-H lineitem
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
   range filter (K1 once per index file read) and Q3 (one arm of the
   join's ladder; K2 and its fence build once where the arm runs K2 — over
   li_st's per-bucket files the presorted route's flat codes pass int32 at
   SF3, K2's plan declines and the native runtime walks the segments, S1
   and S4), each held against numpy; after S4 the walk is timed over
   li_runs and ord_st against the host search it replaced. After S1 the ladder runs on
   li_st, residency auto, each tier from a fresh cache: budgetMB 4096
   (resident, K1c), 320 (compressed: l_quantity and l_shipdate packed,
   K1p) and 64 (streaming: 18 windows of 2^20 rows through a slab pair),
   each with the resident phase's 30 queries, one launch a query (a
   window a query when streaming), rows against numpy and block counts
   against the resident tier's; on the compressed and streaming tiers a
   burst of 16 range filters through a paused ``QueryServer`` launches
   K1b once (a window at a time when streaming: 18 launches);
11. lint — on the host: the port's static analyzer
   (``hyperspace_tpu_torch.tools.lint``'s default targets, both phases)
   must build a project model over every module of the port (``lint
   project: modules M, functions F, edges E, locks L, model seconds S``,
   read from its ``--call-graph-dump``) and find no unsuppressed finding
   (``lint: files N, unsuppressed 0, suppressed K, seconds S``), and the
   live metrics registry, after every other phase,
   must render to Prometheus text with no problem
   (``metrics: families F, problems 0``); S1 of the streaming phase also
   prints its ``build_pipeline_snapshot``;
12. one ``native:`` line (each native entry's calls on the main,
   aggregate, join and streaming paths, counted from zero at each path's
   start, null where the path did not run; its native and plain ms and
   ``max_abs_err``; the host's CPU count and model), one ``kernels`` JSON
   line (with the kernels phase; a kernel's launches are null where none
   of its paths ran), then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero without the last
line. ``--scale`` below 1 cuts both tables' row counts (printed).
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
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
# the phases of a run, in order (--phases); aggregate, resident, join,
# serve, native and front_end run in the main path's session and so need
# main, as does fabric, which serves the main path's li_idx
PHASES = ("kernels", "main", "aggregate", "resident", "join", "serve", "native", "front_end",
          "lifecycle", "hybrid", "reliability", "mesh", "fabric", "streaming", "lint")
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


def own_source(workdir: Path, name: str, table: dict, schema: dict, n_files: int,
               main_name: str):
    """``workdir/src/<name>``, a phase's own source of ``table``: a copy of
    the main path's ``src/<main_name>`` where the main path wrote those
    ``n_files`` from the same table (the run passes every phase the same
    tables), else written anew. Returns (the directory, how it came)."""
    main_dir, dst = workdir / "src" / main_name, workdir / "src" / name
    if main_dir.is_dir() and len(list(main_dir.glob("*.avro"))) == n_files:
        shutil.copytree(main_dir, dst)
        return dst, "copied from the main path's"
    return Path(write_avro_dir(dst, table, schema, n_files)), "written anew"


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
    """Per kernel of a ``ptxas -v`` report: registers, static shared
    memory, stack frame and spill bytes (template arguments of the mask
    kernels and K2p's vpw spelled out). Dynamic shared memory is the
    launch's: K2p's records carry theirs (``smem_bytes``)."""
    import re

    def name(mangled: str) -> str:
        m = re.search(r"([a-z_]+_kernel)(?:ILb([01])ELi(\d+)E|ILi(\d+)ELi(\d+)EE|ILi(\d+)EE)?",
                      mangled)
        if not m:
            return mangled
        if m.group(4) is not None:
            return f"{m.group(1)}<{m.group(4)},{m.group(5)}>"
        if m.group(6) is not None:
            return f"{m.group(1)}<{m.group(6)}>"
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
            smem = re.search(r"(\d+) bytes smem", ln)
            out[current]["static_smem"] = int(smem.group(1)) if smem else 0
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


K2P_KERNEL = "sorted_intersect_packed_kernel"


def k2p_operands(l: np.ndarray, r: np.ndarray, dev):
    """K2p's operands for left keys ``l`` and ascending right keys ``r``,
    as a join region holds them: K2's plan, the right keys FoR-packed
    (block 128) and padded, the raw fences of the narrowed padded keys.
    Returns (planned tensors (s_tile, span, base, l_p), words, refs,
    fences, spec, lo_all, the padded raw right keys, the host plan)."""
    import torch

    from hyperspace_tpu_torch.ops import bitpack
    from hyperspace_tpu_torch.ops import kernels as tk

    plan = tk._plan_sorted_intersect(l, r)
    spec = bitpack.for_spec(r, block=128)
    if plan is None or spec is None:
        raise AssertionError("K2p: the plan or the FoR spec declined")
    r_p = plan[4]
    words, refs = tk.packed_right_operands(r, spec, len(r_p))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ([put(a) for a in plan[:4]], put(words), put(refs), put(r_p[:: tk.K2_FENCE]), spec,
            min(int(l.min()), int(r.min())), put(r_p), plan)


def k2p_groups(plan, spec, dev, target=None, tight=False):
    """K2p's group plan for a K2 host plan, on ``dev``: the card's target
    (``k2p_group_target``) unless ``target`` is given; ``tight`` forces the
    minimal capacity, the plan's largest span."""
    from hyperspace_tpu_torch.ops import kernels as tk

    target = tk.k2p_group_target(dev) if target is None else target
    capacity = int(plan[1].max()) if tight else None
    return tk.plan_k2p_groups(plan[0], plan[1], spec.vpw, target, capacity=capacity).to(dev)


def k2p_case(name: str, l: np.ndarray, r: np.ndarray, dev, plans=((None, False),)):
    """K2p over one input under each group plan of ``plans`` ((target,
    tight) pairs for ``k2p_groups``), held exactly against its plain
    version (``sorted_intersect_packed_reference``) on every padded row,
    and on real rows of tiles the plan does not mark wide against numpy's
    searchsorted. Returns (record, operands, the first plan's groups)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    ops = k2p_operands(l, r, dev)
    t, words, refs, fences, spec, lo_all, _r_p, plan = ops
    p_lt, p_eq = tk.sorted_intersect_packed_reference(*t, words, refs, spec, lo_all,
                                                      int(fences.shape[0]) * tk.K2_FENCE)
    n = len(l)
    keep = ~np.repeat(plan[-1], tk.SMJ_TILE)[:n]
    want = np.searchsorted(r, l, side="left")
    want_eq = np.searchsorted(r, l, side="right") - want
    err, shapes, first = 0, [], None
    for target, tight in plans:
        groups = k2p_groups(plan, spec, dev, target, tight)
        first = first or groups
        lt, eq = tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                                    groups=groups)
        e = max(int((lt - p_lt).abs().max().item()), int((eq - p_eq).abs().max().item()))
        np_ok = (np.array_equal(lt[:n].cpu().numpy()[keep], want[keep])
                 and np.array_equal(eq[:n].cpu().numpy()[keep], want_eq[keep]))
        if e or not np_ok:
            raise AssertionError(f"K2p {name} (groups: target {target}, tight {tight}): kernel "
                                 f"disagrees with plain version (err {e}, numpy {np_ok})")
        err = max(err, e)
        shapes.append(f"{groups.n_groups} groups, window <= {groups.max_window}"
                      + (" (tight)" if tight else ""))
    rec = dict(max_abs_err=err, n_l=n, n_r=len(r), bits=spec.bits, vpw=spec.vpw,
               wide_tiles=int(plan[-1].sum()), max_span=int(plan[1].max()),
               groups=first.n_groups, max_window=first.max_window, smem_bytes=first.smem_bytes)
    log(f"K2p {name}: n_l={n} n_r={len(r)} bits={spec.bits} vpw={spec.vpw} "
        f"wide_tiles={rec['wide_tiles']} max_span={rec['max_span']} plans: {'; '.join(shapes)} "
        f"exact=yes (plain version on every padded row, numpy on the rows of tiles not wide)")
    return rec, ops, first


def j1_epilogue_case(lineitem: dict, orders: dict, l_order: np.ndarray, lt, eq, dev) -> dict:
    """J1's torch epilogue alone (``join_residency._core_agg``): f64 sum
    and non-null count of o_totalprice per l_partkey slot over the match
    ranges K2p gave, against numpy; timed with CUDA events."""
    import torch

    from hyperspace_tpu_torch.exec.join_residency import _core_agg, encode_join_payload
    from hyperspace_tpu_torch.storage.columnar import Column

    n = len(l_order)
    part = lineitem["l_partkey"][l_order]
    mn = int(part.min())
    span = int(part.max()) - mn + 1
    slots = torch.from_numpy((part - mn).astype(np.int32)).to(dev)
    planes, enc = encode_join_payload(Column("float64", orders["o_totalprice"]))
    flat = tuple(torch.from_numpy(p).to(dev) for p in planes)
    lo, cnt = lt[:n].to(torch.int64), eq[:n].to(torch.int64)
    specs = [("r", enc, 2, ("nn", "sum"))]

    def run():
        return _core_agg(specs, span, True, lo, cnt, slots, flat)

    rows, nn, sums = (o.cpu().numpy() for o in run())
    pos = np.searchsorted(orders["o_orderkey"], lineitem["l_orderkey"][l_order])
    want = np.bincount(part - mn, weights=orders["o_totalprice"][pos], minlength=span)
    if not (np.array_equal(rows, np.bincount(part - mn, minlength=span)) and np.array_equal(nn, rows)
            and np.allclose(sums, want, rtol=1e-9, atol=0.0)):
        raise AssertionError("J1 epilogue: disagrees with numpy")
    # bytes: the ranges (int64) and slots read, the payload gathered per
    # left row, three span-sized vectors written
    b_ms, b_by = bound(16 * n + 4 * n + 8 * n + 3 * 8 * span, 0.0)
    rec = dict(ms=time_ms(run), rows=n, groups=span, bound_ms=b_ms, bound_by=b_by)
    log(f"J1 epilogue (index_add_ sum and count over 200,000 slots): rows={n} "
        f"ms={rec['ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) matches numpy (sums rtol 1e-9)")
    return rec


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


def index_order(keys: np.ndarray, dev) -> np.ndarray:
    """The permutation that lays rows out as a covering index on ``keys``
    stores them: grouped by bucket (the build's hash, ``NUM_BUCKETS``),
    key-sorted within each."""
    import torch

    from hyperspace_tpu_torch.ops import build

    bucket = build.device_bucket_ids({"k": torch.from_numpy(keys.astype(np.int64)).to(dev)},
                                     {"k": "int64"}, ["k"], {}, NUM_BUCKETS).cpu().numpy()
    return np.lexsort((keys, bucket))


def k1b_verdicts(progs, values, chunk_rows: int) -> np.ndarray:
    """K1b's range test in numpy: (N, chunks) verdicts of raw ``(n, 4)``
    programs over planes ``values`` (int64, decoded, pad rows included) cut
    into chunks of ``chunk_rows``: 0 no row, 3 every row, 1 counted row by
    row (csrc/predicate_mask.cu: box_verdict for a conjunction of literal
    compares, with a chunk of two ascending runs covered by [first, max]
    and [min, last]; program_verdict for any other program)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    chunks = [v.reshape(-1, chunk_rows) for v in values]
    lo = [c.min(1) for c in chunks]
    hi = [c.max(1) for c in chunks]
    two = [(np.diff(c, axis=1) < 0).sum(1) <= 1 for c in chunks]
    first = [np.where(t, c[:, 0], a) for t, c, a in zip(two, chunks, lo)]
    last = [np.where(t, c[:, -1], b) for t, c, b in zip(two, chunks, hi)]
    out = []
    for prog in progs:
        box = tk.program_box(prog)
        if box is not None:
            if box == "never":
                out.append(np.zeros(len(lo[0]), dtype=np.int64))
                continue
            none = np.zeros(len(lo[0]), dtype=bool)
            every = np.ones(len(lo[0]), dtype=bool)
            for c, blo, bhi in box:
                none |= ((hi[c] < blo) | (first[c] > bhi)) & ((last[c] < blo) | (lo[c] > bhi))
                every &= (blo <= lo[c]) & (hi[c] <= bhi)
            out.append(np.where(none, 0, np.where(every, 3, 1)))
            continue
        st = []
        for op, a, cmp, b in np.asarray(prog).tolist():
            if op in (tk.OP_CMP_LIT, tk.OP_CMP_COL):
                blo, bhi = (b, b) if op == tk.OP_CMP_LIT else (lo[b], hi[b])
                alo, ahi = lo[a], hi[a]
                may, must = (
                    ((alo <= bhi) & (blo <= ahi), (alo == ahi) & (blo == bhi) & (alo == blo)),
                    (~((alo == ahi) & (blo == bhi) & (alo == blo)), (ahi < blo) | (bhi < alo)),
                    (alo < bhi, ahi < blo), (alo <= bhi, ahi <= blo),
                    (ahi > blo, alo > bhi), (ahi >= blo, alo >= bhi))[cmp]
                st.append((np.broadcast_to(may, alo.shape), np.broadcast_to(must, alo.shape)))
            elif op == tk.OP_NOT:
                m, u = st.pop()
                st.append((~u, ~m))
            else:
                (m2, u2), (m1, u1) = st.pop(), st.pop()
                st.append((m1 & m2, u1 & u2) if op == tk.OP_AND else (m1 | m2, u1 | u2))
        m, u = st[-1]
        out.append(np.where(u, 3, np.where(m, 1, 0)))
    return np.stack(out)


def k1b_needed_ops(progs, values, sub_rows: int) -> float:
    """The operations these inputs need of K1b under a plan of ``sub_rows``
    (its chunks are ``max(sub_rows // 8, 128)`` rows): one a row and
    instruction of each program in each chunk the range test leaves to the
    rows, one a chunk and instruction for the test itself."""
    chunk = max(sub_rows // 8, 128)
    v = k1b_verdicts(progs, values, chunk)
    lens = np.array([len(p) for p in progs], dtype=np.float64)
    return float(((v == 1).sum(1) * lens).sum() * chunk + v.shape[1] * lens.sum())


# K1b/K1hb's timed cases at the serving bursts' shapes, each at its layouts:
# "index" as li_idx / li_st hold the rows (bucket, then key: the main path),
# "source" in key order (make_tables' order), "shuffled" a random order (no
# chunk resolves; li_st's planes are random as made)
K1B_TIMED = {"B1": ("index", "source", "shuffled"), "B2": ("index", "source", "shuffled"),
             "L2": ("index", "shuffled"), "L3": ("index", "shuffled"),
             "K1hb": ("index", "source", "shuffled")}
K1B_RECORD = {"B1": "B1_point_N64", "B2": "B2_range_N16", "L2": "L2_packed_N16",
              "L3": "L3_window_N16", "K1hb": "li_hy_N16"}
LI_HY_DELTA_ROWS = 11_891  # li_hy's delta at H2: two RF1 batches of lineitems


class K1bInputs:
    """The operands of K1b/K1hb's timed cases, made once per layout from
    SF1's lineitem (``lineitem``) and li_st's planes (made here at SF3)."""

    def __init__(self, lineitem: dict, dev):
        self.L, self.dev = lineitem, dev
        self.top = int(lineitem["l_orderkey"].max())
        self.n = len(lineitem["l_orderkey"])
        self.perm = {}
        self._st = None

    def order(self, layout: str, keys: np.ndarray, tag: str) -> np.ndarray:
        if (tag, layout) not in self.perm:
            n = len(keys)
            self.perm[(tag, layout)] = (np.arange(n) if layout == "source" else
                                        index_order(keys, self.dev) if layout == "index" else
                                        np.random.default_rng(len(tag)).permutation(n))
        return self.perm[(tag, layout)]

    def plane(self, a, pad_to: int):
        import torch

        t = torch.zeros(pad_to, dtype=torch.int32, device=self.dev)
        t[: len(a)] = torch.from_numpy(np.asarray(a).astype(np.int32)).to(self.dev)
        return t

    def padded(self, a, pad_to: int, fill: int = 0) -> np.ndarray:
        out = np.full(pad_to, fill, dtype=np.int64)
        out[: len(a)] = a
        return out

    def case(self, case: str, layout: str) -> dict:
        """{kind, preds, names, cols, specs, n_rows, values, singles, single_kernel, ...}."""
        from hyperspace_tpu_torch.ops import kernels as tk
        from hyperspace_tpu_torch.plan.expr import col

        B, L, top = tk.BLOCK_ROWS, self.L, self.top
        rng = np.random.default_rng({"B1": 1, "B2": 2, "K1hb": 3}.get(case, 4))
        n_pad = -(-self.n // B) * B
        if case in ("B1", "B2", "K1hb"):
            perm = self.order(layout, L["l_orderkey"], "li")
        if case == "B1":
            ok = L["l_orderkey"][perm]
            keys = rng.choice(np.unique(ok), 64, replace=False)
            preds = [(tk.narrow_expr_to_i32(col("l_orderkey") == int(k)), ("l_orderkey",))
                     for k in keys]
            cols = [self.plane(ok, n_pad)]
            return dict(kind="k1b", preds=preds, names=("l_orderkey",), cols=cols, specs=[None],
                        n_rows=n_pad, values=[self.padded(ok, n_pad)],
                        single=lambda b, pn: tk.predicate_block_counts_tensor(b, pn, cols),
                        single_kernel="predicate_block_counts_kernel")
        if case == "B2":
            names = ("l_orderkey", "l_shipdate")
            arrs = [L[c][perm] for c in names]
            preds = []
            for _ in range(16):
                lo = int(rng.integers(1, top - top // 10))
                d = int(rng.integers(DAY_1992_01_01, DAY_1998_08_02 - 400))
                preds.append((tk.narrow_expr_to_i32(
                    (col("l_orderkey") >= lo) & (col("l_orderkey") < lo + top // 10)
                    & (col("l_shipdate") >= d) & (col("l_shipdate") < d + 365)), names))
            cols = [self.plane(a, n_pad) for a in arrs]
            return dict(kind="k1b", preds=preds, names=names, cols=cols, specs=[None, None],
                        n_rows=n_pad, values=[self.padded(a, n_pad) for a in arrs],
                        single=lambda b, pn: tk.predicate_block_counts_tensor(b, pn, cols),
                        single_kernel="predicate_block_counts_kernel")
        if case == "K1hb":
            names = ("l_orderkey", "l_quantity", "l_shipdate")
            pick = np.random.default_rng(7).integers(0, self.n, LI_HY_DELTA_ROWS)
            nd_pad = -(-LI_HY_DELTA_ROWS // B) * B
            deleted = np.zeros(n_pad, dtype=bool)  # one source file of eight: its rows
            deleted[: self.n] = (np.arange(self.n) >= 2 * self.n // 8) & \
                (np.arange(self.n) < 3 * self.n // 8)
            deleted[: self.n] = deleted[: self.n][perm]
            base = [self.plane(L[c][perm], n_pad) for c in names]
            delta = [self.plane(L[c][pick], nd_pad) for c in names]
            words = self.plane(tk.pack_row_bitmask(deleted).astype(np.int64), n_pad // 32)
            preds = []
            for _ in range(16):
                lo = int(rng.integers(1, top - top // 3))
                preds.append((tk.narrow_expr_to_i32(
                    (col("l_orderkey") >= lo) & (col("l_orderkey") < lo + top // 3)
                    & (col("l_quantity") < 24) & (col("l_shipdate") >= DAY_1995_03_15 - 365)
                    & (col("l_shipdate") < DAY_1995_03_15)), names))
            values = [self.padded(L[c][perm], n_pad) for c in names]
            dvalues = [self.padded(L[c][pick], nd_pad) for c in names]
            return dict(kind="k1hb", preds=preds, names=names, base=base, delta=delta,
                        words=words, n_rows=n_pad + nd_pad, n_base=n_pad, values=values,
                        delta_values=dvalues,
                        single=lambda b, pn: tk.hybrid_block_counts_tensor(b, pn, base, delta,
                                                                           words),
                        single_kernel="hybrid_block_counts_kernel")
        return self._st_case(case, layout)

    def _st_case(self, case: str, layout: str) -> dict:
        """L2 (li_st's three predicate planes, l_quantity and l_shipdate
        packed, 18,006,016 rows) and L3 (its first 2^20-row window)."""
        from hyperspace_tpu_torch.ops import bitpack
        from hyperspace_tpu_torch.ops import kernels as tk
        from hyperspace_tpu_torch.plan.expr import col

        B, st_top = tk.BLOCK_ROWS, 18_000_000
        if self._st is None:
            self._st = li_st_planes(np.random.default_rng(1234), LI_ST_ROWS, st_top)
        names = ("l_orderkey", "l_quantity", "l_shipdate")
        perm = self.order(layout, self._st["l_orderkey"][0], "li_st")
        n = LI_ST_ROWS if case == "L2" else 1 << 20
        n_pad = -(-n // B) * B
        cols, specs, values = [], [], []
        for nm in names:
            v, sp = self._st[nm]
            v = v[perm][:n]
            if sp is None:
                cols.append(self.plane(v, n_pad))
                values.append(self.padded(v, n_pad))
            else:
                sp = bitpack.PackSpec(sp.bits, sp.vpw, n_pad, sp.ref0)
                full = self.padded(v, n_pad, sp.ref0)
                import torch

                cols.append(torch.from_numpy(bitpack.pack_plain(full, sp)).to(self.dev))
                values.append(full)
            specs.append(sp)
        rng = np.random.default_rng(16)
        preds = []
        for _ in range(16):
            lo = int(rng.integers(1, st_top - st_top // 6))
            preds.append((tk.narrow_expr_to_i32(
                (col("l_orderkey") >= lo) & (col("l_orderkey") < lo + st_top // 6)
                & (col("l_quantity") < int(rng.integers(5, 50)))
                & (col("l_shipdate") >= DAY_1995_03_15 - 365)
                & (col("l_shipdate") < DAY_1995_03_15)), names))
        return dict(kind="k1b", preds=preds, names=names, cols=cols, specs=specs, n_rows=n_pad,
                    values=values,
                    single=lambda b, pn: tk.predicate_block_counts_packed_tensor(
                        b, pn, cols, specs, n_pad),
                    single_kernel="predicate_block_counts_packed_kernel")


def k1b_run(inp: dict, **plan):
    """One call of the K1b/K1hb wrapper the burst would make over ``inp``
    (``plan``: sub_rows / stages / shape overrides, see
    ``ops/kernels.py:k1b_plan``)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    progs = tk.batch_programs(inp["preds"], inp["names"])
    if inp["kind"] == "k1hb":
        return tk.program_hybrid_counts_batch_tensor(progs, inp["base"], inp["delta"],
                                                     inp["words"], **plan)
    return tk.program_block_counts_batch_tensor(progs, inp["cols"], inp["specs"], inp["n_rows"],
                                                **plan)


def k1b_wrapper(inp: dict):
    """The entry point the serving layer calls (lowering cache included)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    if inp["kind"] == "k1hb":
        return tk.hybrid_block_counts_batch_tensor(inp["preds"], inp["names"], inp["base"],
                                                   inp["delta"], inp["words"])
    return tk.predicate_block_counts_batch_tensor(inp["preds"], inp["names"], inp["cols"],
                                                  inp["specs"], inp["n_rows"])


def k1b_plain(inp: dict):
    from hyperspace_tpu_torch.ops import kernels as tk

    if inp["kind"] == "k1hb":
        return tk.hybrid_block_counts_batch_reference(inp["preds"], inp["names"], inp["base"],
                                                      inp["delta"], inp["words"])
    return tk.predicate_block_counts_batch_reference(inp["preds"], inp["names"], inp["cols"],
                                                     inp["specs"], inp["n_rows"])


def k1b_bound(inp: dict, sub_rows: int):
    """(bound ms, by, needed ops): the planes read once, the counts written
    once (and K1hb's mask, one bit a base row), against the operations
    these inputs need under a plan of ``sub_rows`` (``k1b_needed_ops``)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    progs = [p.prog for p in tk.batch_programs(inp["preds"], inp["names"])]
    N, nb = len(progs), inp["n_rows"] // tk.BLOCK_ROWS
    if inp["kind"] == "k1hb":
        nbytes = 4 * len(inp["names"]) * inp["n_rows"] + inp["n_base"] // 8 + 4 * N * nb
        ops = k1b_needed_ops(progs, inp["values"], sub_rows) + \
            k1b_needed_ops(progs, inp["delta_values"], sub_rows)
    else:
        nbytes = sum(4 * int(c.numel()) for c in inp["cols"]) + 4 * N * nb
        ops = k1b_needed_ops(progs, inp["values"], sub_rows)
    ms, by = bound(nbytes, ops)
    return ms, by, ops


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


def batch_kernel_cases(lineitem: dict, seed: int, dev) -> dict:
    """K1b and K1hb (N programs in one launch: the serving layer's
    micro-batches) against their plain versions on the card, exactly:

    * K1b: N = 1, 2, 16, 64 and 300 (past the 240 instructions a K1
      parameter block holds: programs, offsets, descriptors and addresses
      ride a device buffer), programs of depth 1 to 9 in one batch, packed
      planes of every width 1-16 beside raw and f64 planes, real rows that
      end mid-word with pad rows (zeros raw, ref0 packed), 40 raw planes
      (a sub-tile under 1024 rows), and a 2^20-row streaming window;
    * K1hb: no mask, every base row deleted and random deletions, deltas of
      1 row and of several blocks, N = 1, 16 and 64;
    * both on the cases aimed at their range test (``ops/k1b_cases.py``:
      constant chunks, literals at chunk minima and maxima and one past,
      the int32 extremes, pad rows inside resolved chunks, packed widths
      1-16 with ref0 below zero, deletions of whole and partial chunks), N
      = 1, 2, 16, 64 (in the parameter block) and 300 (staged), every
      sub-tile from 4096 to 128 rows and rings of 2 to 4 stages.

    Timed at the serving bursts' shapes (``K1B_TIMED``): B1 (64 point
    lookups over li_idx's order keys), B2 (16 range filters over order key
    and ship date), L2 (16 range filters over li_st's packed planes), L3
    (the same over one 2^20-row window: 128 blocks) and the hybrid burst
    (16 filters over li_hy's base and delta), each at the index layout the
    served planes have and at a shuffled one (where no chunk resolves),
    B1, B2 and the hybrid burst also in key order; at the index layout
    beside N launches of the single kernel the batch replaces."""
    import torch

    from hyperspace_tpu_torch.ops import bitpack, k1b_cases
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.ops.floatbits import f64_to_ordered_i64, ordered_i64_planes
    from hyperspace_tpu_torch.plan.expr import col

    rng = np.random.default_rng(seed + 20)
    B = tk.BLOCK_ROWS
    k1b, k1hb = {}, {}

    def planes_for(n_real, n_pad, widths, n_raw, f64=True):
        """Packed planes of ``widths`` bits, ``n_raw`` raw planes and an f64
        column's two planes over ``n_real`` rows padded to ``n_pad``."""
        cols, specs, names, values = [], [], [], {}
        for bits in widths:
            lo = -int(rng.integers(0, 5000))
            v = rng.integers(lo, lo + (1 << bits), n_real)
            sp = bitpack.pack_spec(lo, lo + (1 << bits) - 1, n_real)
            sp = bitpack.PackSpec(sp.bits, sp.vpw, n_pad, sp.ref0)
            padded = np.full(n_pad, sp.ref0, dtype=np.int64)
            padded[:n_real] = v
            cols.append(torch.from_numpy(bitpack.pack_plain(padded, sp)).to(dev))
            specs.append(sp)
            names.append(f"p{bits:02d}")
            values[names[-1]] = (lo, 1 << bits)
        raw = [rng.integers(-10**6, 10**6, n_real).astype(np.int32) for _ in range(n_raw)]
        if f64:
            hi, lo_plane = ordered_i64_planes(f64_to_ordered_i64(
                np.round(rng.uniform(-100.0, 100.0, n_real), 2)))
            raw += [hi, lo_plane]
        for i, a in enumerate(raw):
            t = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            t[:n_real] = torch.from_numpy(a).to(dev)
            cols.append(t)
            specs.append(None)
            names.append(f"r{i:02d}")
            values[names[-1]] = (-10**6, 2 * 10**6)
        return cols, specs, tuple(names), values

    def programs(names, values, n_progs):
        out = []
        for i in range(n_progs):
            a = names[i % len(names)]
            lo, width = values[a]
            e = col(a) >= lo + int(rng.integers(0, width))
            for d in range(i % 9):
                b = names[(3 * i + d) % len(names)]
                lo_b, w_b = values[b]
                c = col(b) < lo_b + int(rng.integers(0, w_b))
                e = (e & c) if d % 2 else (e | ~c)
            out.append(tk.lower_predicate(tk.narrow_expr_to_i32(e), names))
        return out

    def held_batch(name, progs, cols, specs, n_pad, **rec):
        got = tk.program_block_counts_batch_tensor(progs, cols, specs, n_pad)
        want = tk.program_block_counts_batch_tensor(progs, [c.cpu() for c in cols], specs, n_pad)
        shape = []
        tk.program_block_counts_batch_tensor(progs, cols, specs, n_pad, shape=shape)
        k1b[name] = dict(max_abs_err=_held(f"K1b {name}", got, want.to(dev)), n=len(progs),
                         planes=len(cols), rows=n_pad, sub_rows=shape[3].sub_rows,
                         matches=int(want.sum().item()), **rec)

    n_real, n_pad = 5 * B - 3, 5 * B
    cols, specs, names, values = planes_for(n_real, n_pad, range(1, 17), 2)
    progs = programs(names, values, 300)
    for N in (1, 2, 16, 64, 300):
        held_batch(f"mixed_N{N}", progs[:N], cols, specs, n_pad, instr=sum(len(p) for p in progs[:N]))
    cols40, specs40, names40, values40 = planes_for(n_real, n_pad, (), 40, f64=False)
    held_batch("raw40_N16", programs(names40, values40, 16), cols40, specs40, n_pad)
    del cols40
    wcols, wspecs, wnames, wvalues = planes_for(1 << 20, 1 << 20, (6, 12), 1, f64=False)
    held_batch("window_2p20_N16", programs(wnames, wvalues, 16), wcols, wspecs, 1 << 20)
    del wcols
    log(f"K1b: {len(k1b)} cases (N 1-300, depths 1-9 in one batch, widths 1-16 beside raw and "
        f"f64 planes, rows ending mid-word, 40 raw planes (sub_rows "
        f"{k1b['raw40_N16']['sub_rows']}), a 2^20-row window) exact=yes")

    for nb, d_real in ((3, 1), (2, 4 * B - 100)):
        names_h = ("a", "b", "c")
        base = [torch.from_numpy(rng.integers(-99, 99, nb * B).astype(np.int32)).to(dev)
                for _ in names_h]
        delta = [torch.zeros(-(-d_real // B) * B, dtype=torch.int32, device=dev) for _ in names_h]
        for t in delta:
            t[:d_real] = torch.from_numpy(rng.integers(-99, 99, d_real).astype(np.int32)).to(dev)
        hvals = {n: (-99, 198) for n in names_h}
        hprogs = programs(names_h, hvals, 64)
        for label, rows in (("no_mask", None), ("all", np.ones(nb * B, bool)),
                            ("random", rng.random(nb * B) < 0.3)):
            words = None if rows is None else torch.from_numpy(tk.pack_row_bitmask(rows)).to(dev)
            for N in (1, 16, 64):
                got = tk.program_hybrid_counts_batch_tensor(hprogs[:N], base, delta, words)
                want = tk.program_hybrid_counts_batch_tensor(
                    hprogs[:N], [t.cpu() for t in base], [t.cpu() for t in delta],
                    None if words is None else words.cpu())
                case = f"base{nb}_delta{d_real}_{label}_N{N}"
                k1hb[case] = dict(max_abs_err=_held(f"K1hb {case}", got, want.to(dev)),
                                  matches=int(want.sum().item()))
    log(f"K1hb: {len(k1hb)} cases (no mask, all rows deleted, random deletions; deltas of 1 row "
        f"and of several blocks; N 1, 16, 64) exact=yes")

    # the cases aimed at the range test (ops/k1b_cases.py), every N, plan and
    # deletion, as tests/test_torch_serve.py runs them
    cases = k1b_cases.k1b_range_cases(seed)
    n = k1b_cases.N_BLOCKS * B
    for kind in ("raw", "packed"):
        c = cases[kind]
        planes = [torch.from_numpy(p).to(dev) for p in c["planes"]]
        for N in (1, 2, 16, 64, 300):
            want = tk.program_block_counts_batch_tensor(c["progs"][:N], [p.cpu() for p in planes],
                                                        c["specs"], n).to(dev)
            for sub, stages in k1b_cases.PLANS[kind]:
                got = tk.program_block_counts_batch_tensor(c["progs"][:N], planes, c["specs"], n,
                                                           sub_rows=sub, stages=stages)
                k1b[f"range_{kind}_N{N}_sub{sub}_st{stages}"] = dict(
                    max_abs_err=_held(f"K1b range {kind} N{N} sub {sub} stages {stages}", got, want),
                    matches=int(want.sum().item()))
    h = cases["hybrid"]
    hb = [torch.from_numpy(x).to(dev) for x in h["base"]]
    hd = [torch.from_numpy(x).to(dev) for x in h["delta"]]
    for name in k1b_cases.DELETIONS:
        words = torch.from_numpy(tk.pack_row_bitmask(k1b_cases.deletion_rows(name, h["n_base"])))
        want = tk.program_hybrid_counts_batch_tensor(h["progs"], [t.cpu() for t in hb],
                                                     [t.cpu() for t in hd], words).to(dev)
        for sub in (None, 2048, 512):
            got = tk.program_hybrid_counts_batch_tensor(h["progs"], hb, hd, words.to(dev),
                                                        sub_rows=sub)
            k1hb[f"range_{name}_sub{sub}"] = dict(
                max_abs_err=_held(f"K1hb range {name} sub {sub}", got, want),
                matches=int(want.sum().item()))
    log(f"K1b/K1hb range test: {sum(k.startswith('range_') for k in k1b)} K1b cases (constant "
        f"chunks, chunk-edge literals, int32 extremes, pad rows in resolved chunks, widths 1-16 "
        f"with ref0 < 0; N 1-300, sub-tiles 4096-128, 2-4 stages) and "
        f"{sum(k.startswith('range_') for k in k1hb)} K1hb cases (deletions: "
        f"{', '.join(k1b_cases.DELETIONS)}) exact=yes")

    # timed at the serving bursts' shapes, at each layout of K1B_TIMED; at
    # the index layout (the main path's) also the plain version and the N
    # single launches the batch replaces
    inputs = K1bInputs(lineitem, dev)
    for case, layouts in K1B_TIMED.items():
        for layout in layouts:
            inp = inputs.case(case, layout)
            name = K1B_RECORD[case] + ("" if layout == "index" else f"@{layout}")
            what = "K1hb" if inp["kind"] == "k1hb" else "K1b"
            err = _held(f"{what} {name}", k1b_wrapper(inp), k1b_plain(inp))
            shape = []
            k1b_run(inp, shape=shape)
            grid, per_sm, inst, plan = shape
            b_ms, b_by, ops = k1b_bound(inp, plan.sub_rows)
            rec = dict(max_abs_err=err, n=len(inp["preds"]), rows=inp["n_rows"], layout=layout,
                       sub_rows=plan.sub_rows, stages=plan.stages, staged=plan.staged, grid=grid,
                       ctas_per_sm=per_sm, instantiation=inst, needed_ops=ops,
                       ms=time_ms(lambda: k1b_wrapper(inp)),
                       device_ms=device_ms(lambda: k1b_wrapper(inp), "block_counts_batch_kernel"),
                       plain_ms=time_ms(lambda: k1b_plain(inp), repeats=5)
                       if layout == "index" else None,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
            msg = (f"{what} {name}: N={rec['n']} rows={rec['rows']} sub_rows={plan.sub_rows} "
                   f"stages={plan.stages} grid={grid} ctas_per_sm={per_sm} ms={rec['ms']:.4f} "
                   f"device_ms={_fmt(rec['device_ms'])} plain_ms={_fmt(rec['plain_ms'])} "
                   f"bound_ms={b_ms:.4f} ({b_by}; needed ops {ops:.0f}) library_ms=null exact=yes")
            if layout == "index":
                single, N = inp["single"], len(inp["preds"])
                per = device_ms(lambda: single(*inp["preds"][0]), inp["single_kernel"])
                rec.update(single_n_ms=time_ms(lambda: [single(b_, pn) for b_, pn in inp["preds"]],
                                               repeats=10),
                           single_n_device_ms=None if per is None else per * N)
                msg += (f" | {N} launches of {inp['single_kernel']}: ms={rec['single_n_ms']:.4f} "
                        f"device_ms={_fmt(rec['single_n_device_ms'])} (the route the batch "
                        f"replaces)")
            log(msg)
            (k1hb if inp["kind"] == "k1hb" else k1b)[name] = rec
            del inp
    del inputs
    torch.cuda.empty_cache()
    return {"k1b": k1b, "k1hb": k1hb}


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
    # K2p at the join region's shape: the same left keys in index layout,
    # orders' sorted keys FoR-packed; raw K2 over the same codes beside it
    k2p = {}
    rec, ops, groups = k2p_case("region_layout", l_codes, r_sorted, dev,
                                plans=((None, False), (None, True)))
    t, words, refs, fences_p, spec, lo_all, r_p, plan = ops
    max_span = int(plan[1].max())
    run_p = lambda: tk.sorted_intersect_packed_tensors(  # noqa: E731
        *t, words, refs, fences_p, spec, lo_all, groups=groups)
    run_raw = lambda: tk.sorted_intersect_tensors(  # noqa: E731
        *t, r_p, fences_p, max_span=max_span)
    n_r_pad = int(r_p.shape[0])
    # the function's bytes, each input read once and each output written
    # once: the left keys, the packed words and refs, the fence array,
    # (lt, eq)
    b_ms, b_by = bound(4 * len(plan[3]) + 4 * int(words.shape[0]) + 4 * int(refs.shape[0])
                       + 4 * int(fences_p.shape[0]) + 8 * len(plan[3]), 0.0)
    rec.update(ms=time_ms(run_p), device_ms=device_ms(run_p, K2P_KERNEL),
               plain_ms=time_ms(lambda: tk.sorted_intersect_packed_reference(
                   *t, words, refs, spec, lo_all, n_r_pad), repeats=5),
               library_ms=time_ms(lambda: searchsorted_pair(r_p, t[3])),
               raw_k2_ms=time_ms(run_raw), raw_k2_device_ms=device_ms(run_raw,
                                                                      "sorted_intersect_kernel"),
               bound_ms=b_ms, bound_by=b_by, packed_mb=spec.packed_nbytes / 1e6,
               raw_mb=4 * len(r_sorted) / 1e6)
    k2p["region_layout"] = rec
    log(f"K2p region_layout: {groups.n_groups} groups, windows <= {groups.max_window} right "
        f"tiles ({groups.smem_bytes} B of shared memory) | ms={rec['ms']:.4f} "
        f"device_ms={_fmt(rec['device_ms'])} | raw K2 "
        f"over the same codes ms={rec['raw_k2_ms']:.4f} device_ms={_fmt(rec['raw_k2_device_ms'])} "
        f"| plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} (torch.searchsorted "
        f"x2) bound_ms={b_ms:.4f} ({b_by}) | right codes {rec['packed_mb']:.3f} MB packed, "
        f"{rec['raw_mb']:.3f} MB raw")
    from hyperspace_tpu_torch.ops.k2_cases import k2p_edge_cases, k2p_region_cases

    for name, (l, r) in k2p_edge_cases(seed).items():
        k2p[f"edge_{name}"] = k2p_case(f"edge {name}", l, r, dev)[0]
    # the region cases (index layouts, spans of 64, wide and span-0 tiles,
    # duplicate runs, a ragged right side) under the card's target, a
    # target of 4 (groups of many tiles) and the minimal capacity
    for name, (l, r) in k2p_region_cases(seed).items():
        k2p[f"region_{name}"] = k2p_case(f"region {name}", l, r, dev,
                                         plans=((None, False), (4, False), (4, True)))[0]
    lt_p, eq_p = run_p()
    if plan[-1].any():  # the region patches its wide rows; here numpy does
        wide_rows = np.flatnonzero(np.repeat(plan[-1], tk.SMJ_TILE)[: len(l_codes)])
        q = l_codes[wide_rows]
        w_lo = np.searchsorted(r_sorted, q, side="left")
        lt_p[torch.from_numpy(wide_rows).to(dev)] = torch.from_numpy(w_lo.astype(np.int32)).to(dev)
        eq_p[torch.from_numpy(wide_rows).to(dev)] = torch.from_numpy(
            (np.searchsorted(r_sorted, q, side="right") - w_lo).astype(np.int32)).to(dev)
    j1_epi = j1_epilogue_case(lineitem, orders, np.lexsort((l_keys, bucket)), lt_p, eq_p, dev)
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
        arm = "kernel" if metrics.get("join.fused_agg.path.kernel") else "torch"
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
    out = {"k1": k1, "k1c": k1c, "k2": k2, "k2f": k2f, "k2p": k2p, "j1_epilogue": j1_epi,
           "fused_agg": agg}
    out.update(residency_kernel_cases(lineitem, seed, dev))
    out.update(batch_kernel_cases(lineitem, seed, dev))
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


def query_trace_summary(profile_dir: Path, device: str, missing: int) -> dict:
    """The one Chrome trace the per-query profiler wrote into
    ``profile_dir``: its bytes, its launch ranges, its CUDA runtime calls
    and its kernel names (the device functions' events). On the card it
    must name ``hs_predicate_mask`` (the range around K1's launch) and hold
    its ``cudaLaunchKernel``; K1's device function must be among its
    kernels unless the profiler said it dropped kernel records
    (``missing``, the ``trace.profile.device_records_missing`` count: the
    card's timestamps can fall outside the profiler's window on this
    machine, ``tools/profile_probe.py``). Off the card (a rehearsal: K1's
    plain version, no launch) it must hold events."""
    traces = sorted(profile_dir.glob("query-*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"query profile: {len(traces)} traces in {profile_dir}, want 1")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    if not events:
        raise AssertionError(f"query profile: {traces[0]} holds no events")
    kernels, runtime = (sorted({e.get("name", "") for e in events if e.get("cat") == cat})
                        for cat in ("kernel", "cuda_runtime"))
    ranges = sorted({e.get("name", "") for e in events
                     if str(e.get("name", "")).startswith("hs_")})
    k1_seen = any("predicate_mask_kernel" in k for k in kernels)
    if device != "cpu":
        if "hs_predicate_mask" not in ranges or "cudaLaunchKernel" not in runtime:
            raise AssertionError(f"query profile: no hs_predicate_mask launch (ranges {ranges}, "
                                 f"runtime {runtime})")
        if not k1_seen and not missing:
            raise AssertionError(f"query profile: no K1 device function among {kernels}, and "
                                 "trace.profile.device_records_missing did not count it")
    rec = {"trace_bytes": traces[0].stat().st_size, "events": len(events), "ranges": ranges,
           "runtime": runtime, "kernels": kernels, "device_records_missing": missing}
    log(f"query point_lookup profile: trace {rec['trace_bytes']} bytes, {rec['events']} events, "
        f"ranges {ranges}, kernels {kernels}"
        + (" (kernel records fell outside the profiler's window: "
           "trace.profile.device_records_missing 1)" if missing else ""))
    return rec


def start_lint(dump: Path) -> subprocess.Popen:
    """The port's analyzer over its default targets (``python -m
    hyperspace_tpu_torch.tools.lint``, both phases, JSON and per-rule
    timings, no cache) in a process of its own, writing the project
    model's call graph to ``dump``: it reads only the sources, so it runs
    while the phases before the lint phase do."""
    from hyperspace_tpu_torch.tools.lint import DEFAULT_TARGETS

    root = Path(__file__).resolve().parent
    return subprocess.Popen(
        [sys.executable, "-m", "hyperspace_tpu_torch.tools.lint", "--format", "json",
         "--timings", "--call-graph-dump", str(dump), *(str(root / t) for t in DEFAULT_TARGETS)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def lint_phase(proc=None, dump=None) -> dict:
    """The analyzer's verdict (``start_lint``'s process writing its call
    graph to ``dump``, started now when none is given): no unsuppressed
    finding, a project model over every module of the port, and value-flow
    facts in its call graph; then the live registry's Prometheus text,
    after every other phase, validated the way a scraper would (no
    problem)."""
    from hyperspace_tpu_torch.analysis import iter_python_files
    from hyperspace_tpu_torch.telemetry import export
    from hyperspace_tpu_torch.tools.lint import DEFAULT_TARGETS

    tmp = None
    if proc is None:
        tmp = tempfile.mkdtemp(prefix="hs_lint_")
        dump = Path(tmp) / "callgraph.json"
        proc = start_lint(dump)
    try:
        out, err = proc.communicate(timeout=600)
        graph = json.loads(dump.read_text()) if dump.exists() else None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    findings = json.loads(out)["findings"] if out.strip() else []
    unsuppressed = [f for f in findings if not f["suppressed"]]
    if proc.returncode != 0 or unsuppressed:
        raise AssertionError(f"lint: exit {proc.returncode}, unsuppressed findings "
                             f"{unsuppressed}\n{err[-4000:]}")
    lint_s = float(re.search(r"total: ([0-9.]+) s", err).group(1))
    model_s = float(re.search(r"project-model: ([0-9.]+) ms", err).group(1)) / 1e3
    root = Path(__file__).resolve().parent
    files = list(iter_python_files([root / t for t in DEFAULT_TARGETS]))
    n_files = len(files)
    if graph is None:
        raise AssertionError(f"lint project: no call graph written\n{err[-4000:]}")
    want = {".".join(f.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
            for f in files}
    missing = sorted(want - set(graph["modules"]))
    if missing:
        raise AssertionError(f"lint project: the model lacks {len(missing)} modules: {missing[:20]}")
    fns = graph["functions"]
    edges = sum(len(f["calls"]) for f in fns.values())
    log(f"lint project: modules {len(graph['modules'])}, functions {len(fns)}, edges {edges}, "
        f"locks {len(graph['locks'])}, model seconds {model_s:.3f}")
    # the value flow's facts (HS015-HS020): device returns and params, D2H
    # coercions, transfer sites and compile factories, per function
    flows = [f["valueflow"] for f in fns.values() if "valueflow" in f]
    if not flows:
        raise AssertionError(f"lint flow: the call graph holds no valueflow entry\n{err[-4000:]}")
    flow_s = float(re.search(r"device-flow: ([0-9.]+) ms", err).group(1)) / 1e3
    d2h = sum(len(f.get("d2h", ())) for f in flows)
    transfers = sum(len(f.get("transfers", ())) for f in flows)
    factories = sum(len(f.get("jit_factories", ())) for f in flows)
    log(f"lint flow: functions {len(flows)}, d2h {d2h}, transfers {transfers}, "
        f"jit factories {factories}, device-flow {flow_s:.3f} s")
    log(f"lint: files {n_files}, unsuppressed 0, suppressed {len(findings)}, seconds {lint_s:.3f}")
    text = export.render_prometheus()
    problems = export.check_prometheus(text)
    families = sum(1 for line in text.splitlines() if line.startswith("# TYPE "))
    if problems:
        raise AssertionError(f"metrics: {len(problems)} problems: {problems[:20]}")
    log(f"metrics: families {families}, problems 0")
    return {"files": n_files, "unsuppressed": 0, "suppressed": len(findings), "lint_s": lint_s,
            "modules": len(graph["modules"]), "functions": len(fns), "edges": edges,
            "locks": len(graph["locks"]), "model_s": model_s, "flow_functions": len(flows),
            "d2h": d2h, "transfers": transfers, "jit_factories": factories, "flow_s": flow_s,
            "families": families, "problems": 0}


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
    same session, then the lifecycle, hybrid and reliability phases, each
    in its own; every result is checked against numpy. ``phases``
    (``PHASES``) names the ones to run: the same-session ones need "main",
    the lifecycle, hybrid, reliability and mesh phases run without it. Each
    phase but reliability and mesh ends with its degrade counters at 0;
    those two end with the one loss each injects. Returns timings and
    counts."""
    out = {}
    watch_degrades()
    t0 = time.perf_counter()
    if "main" in phases:
        out.update(_main_session(lineitem, orders, workdir, device, seed, profile, phases))
        log(f"phase seconds: the main path's session {time.perf_counter() - t0:.1f} s")
        degrade_guard("the main path's session")
    # the phases that inject a device loss, and the degrades they make
    injected = {"reliability": ({"serve.degraded": 1}, "R5"),
                "mesh": ({"shuffle.device_failed": 1, "scan.resident_mesh.device_failed": 1},
                         "M6's and MR8's")}
    for name, fn in (("lifecycle", lifecycle_phase), ("hybrid", hybrid_phase),
                     ("reliability", reliability_phase), ("mesh", mesh_phase),
                     ("fabric", fabric_phase)):
        if name in phases:
            t0 = time.perf_counter()
            kw = {"single_build_s": out.get("build_s")} if name == "mesh" else {}
            out[name] = fn(lineitem, orders, workdir, device, seed, profile, **kw)
            log(f"phase seconds: {name} {time.perf_counter() - t0:.1f} s")
            if name in injected:  # the injected losses: consume their latches
                counters, where = injected[name]
                want = {**dict.fromkeys(DEGRADE_COUNTERS, 0), **counters}
                if _DEGRADES != want:
                    raise AssertionError(f"{name}: degrade counters {_DEGRADES}, want {want}")
                log(f"{name}: degrade counters {dict(_DEGRADES)} ({where} injected loss)")
                _DEGRADES.update(dict.fromkeys(DEGRADE_COUNTERS, 0))
            else:
                degrade_guard(name)
    return out


def _main_session(lineitem, orders, workdir: Path, device: str, seed: int, profile: bool,
                  phases) -> dict:
    """The main path's session: both indexes, the three queries, then the
    aggregate, resident and front-end phases named in ``phases``."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    # the main path starts here: kernel launches and native calls from zero
    reset_launch_counts()
    native.reset_call_counts()
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
    # the point lookup runs under the per-query profiler (conf
    # hyperspace.tpu.profile.dir; --profile runs its own profiler instead)
    profile_dir = workdir / "query_profile"
    for q in list(queries) + ["q3_join"]:
        df = q3 if q == "q3_join" else queries[q][0]
        traced = q == "point_lookup" and not profile
        if traced:
            session.conf.set("hyperspace.tpu.profile.dir", str(profile_dir))
            missing0 = metrics.get("trace.profile.device_records_missing")
        t0 = time.perf_counter()
        with _Profiled(f"query {q}", profile):
            results[q] = df.collect()
        fence(session.device)
        out["query_s"][q] = time.perf_counter() - t0
        out["rows"][q] = results[q].num_rows
        if traced:
            session.conf.unset("hyperspace.tpu.profile.dir")
            out["query_profile"] = query_trace_summary(
                profile_dir, device, metrics.get("trace.profile.device_records_missing") - missing0)
    out["launches"] = launch_counts()
    # Q3's two presorted sides join through K2's ranges and the C++
    # gather (the range filter's 200 files, just written, are in the page
    # cache: read_batches maps them, and hs_pread_many counts 0)
    out["native_calls"] = native.call_counts()
    if out["native_calls"].get("hs_expand_gather") != 1:
        raise AssertionError(f"main path: native calls {out['native_calls']}")
    for q, (_df, cols, mask) in queries.items():
        _check(q, results[q], cols, [L[c][mask] for c in cols])
    _check("q3_join", results["q3_join"],
           ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate", "o_totalprice"],
           q3_want)
    for q in out["query_s"]:
        log(f"query {q}: {out['query_s'][q]:.4f} s rows={out['rows'][q]} matches numpy reference")
    log(f"main path: native calls {out['native_calls']}")
    t0 = time.perf_counter()
    if "aggregate" in phases:
        out["aggregate"] = aggregate_phase(session, li, od, q3, L, O, profile)
    if "resident" in phases:
        out["resident"] = resident_phase(session, hsp, li, L, seed, profile)
    if "join" in phases:
        t1 = time.perf_counter()
        out["join"] = join_phase(session, li, od, q3, q3_want, L, O, profile)
        out["join"]["phase_s"] = time.perf_counter() - t1
        log(f"phase seconds: join {out['join']['phase_s']:.1f} s")
    if "serve" in phases:
        t1 = time.perf_counter()
        out["serve"] = serve_phase(session, hsp, li, od, L, O, seed, profile)
        out["serve"]["phase_s"] = time.perf_counter() - t1
        log(f"phase seconds: serve {out['serve']['phase_s']:.1f} s")
    log(f"phase seconds: aggregate, resident and join {time.perf_counter() - t0:.1f} s")
    if "native" in phases:
        t0 = time.perf_counter()
        out["native"] = native_phase(session, L, workdir)
        log(f"phase seconds: native {time.perf_counter() - t0:.1f} s")
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
      match ranges (K2 and its fence build once) into the aggregate, on
      the native single-pass arm (``join_fused_native``: one C++ pass of
      ``hs_group_agg_ranges_f64`` for o_totalprice's sum and average);
    * A2 ``q3_grouped``: the main path's Q3 ending as TPC-H Q3 ends,
      grouped by (l_orderkey, o_orderdate) — keys on both sides, so the
      join is materialized (K2 once, then the C++ gather) and
      hash-aggregated;
    * A3 ``q1_shape``: the range filter's order-key and ship-date windows
      through K1 (once per index file read), grouped by l_quantity (50
      groups) with all five functions, min/max over date32; then a HAVING
      filter on the count;
    * A4 ``q6_shape``: a global aggregate over the full range filter.

    Each query's explain must show the index scans under the Aggregate,
    and its result equal numpy's."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.plan.expr import col

    native.reset_call_counts()
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
    want["q1_shape"] = q1_shape_truth(L, w_mask)
    cnt = want["q1_shape"]["count"]
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
        fused = m.get("aggregate.path.join_fused_native", 0)
        join_arm = list(join_arms(m))
        expand = expand_arms(m)
        read = m.get("scan.files_read", 0)
        k2_want = (1 if on_card else 0) if arm != "scan" else 0
        # A1 on the native single-pass arm alone; A2's join expands and
        # gathers in C++
        if (launches.get(tk.K2, 0), launches.get(tk.K2F, 0)) != (k2_want, k2_want) or \
                fused != (1 if arm == "fused" else 0) or m.get("aggregate.path.join_fused") or \
                expand != ({"join.path.native_smj_gather": 1} if arm == "materialized" else {}):
            raise AssertionError(f"aggregate {name}: launches {launches}, counters {m}")
        # the first run of each join shape: both index sides key-sorted
        # per bucket, so the presorted route, K2 over the flat-remapped
        # codes and no argsort (a repeat would hit the caches)
        if arm != "scan" and join_arm != ["join.path.presorted_merge_flat"]:
            raise AssertionError(f"aggregate {name}: join arms {join_arm}, not the presorted "
                                 f"route alone")
        if arm == "scan" and (read <= 0 or launches.get(tk.K1, 0) != (read if on_card else 0)):
            raise AssertionError(f"aggregate {name}: K1 launches {launches}, files read {read}")
        out[name] = {"s": t_q, "groups": res.num_rows, "launches": launches, "arm": arm,
                     "join_fused_native": fused, "join_path": join_arm,
                     "join_expand": list(expand), "files_read": read,
                     "aggregate_total_s": _times.get("aggregate.total", (0.0, 0))[0],
                     "aggregate_join_ranges_s": _times.get("aggregate.join_ranges", (0.0, 0))[0],
                     "join_bucketed_ranges_s": _times.get("join.bucketed_ranges", (0.0, 0))[0]}
        log(f"aggregate {name}: {t_q:.4f} s groups={res.num_rows} arm={arm} "
            f"join_fused_native={fused} join path={join_arm} expand={list(expand)} "
            f"files read={read} launches={launches} "
            f"| timers aggregate.total={out[name]['aggregate_total_s']:.4f} s "
            f"aggregate.join_ranges={out[name]['aggregate_join_ranges_s']:.4f} s "
            f"join.bucketed_ranges={out[name]['join_bucketed_ranges_s']:.4f} s "
            f"| matches numpy")
    out["native_calls"] = native.call_counts()
    if out["native_calls"].get("hs_group_agg_ranges_f64") != 1:
        raise AssertionError(f"aggregate: native calls {out['native_calls']}")
    log(f"aggregate: native calls {out['native_calls']}")
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


SERVE_COLS = ["l_orderkey", "l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]


def serve_phase(session, hsp, li, od, L: dict, O: dict, seed: int, profile: bool = False) -> dict:
    """The whole-plan compiler and the query server on li_idx (SF1, 200
    buckets), in the main path's session with residency ``auto`` (``force``
    off the card) and li_idx's five columns prefetched (six int32 planes):

    1. compiled scans: the resident phase's 30 queries, then again with
       fresh literals: ``compile.run.scan`` 30 a round, the second round
       all pipeline cache hits, one K1c launch a query; rows against numpy;
    2. ``agg_scan`` on the card: A3's ``q1_shape`` (50 groups, five
       functions) and Q17's inner aggregate over lineitem alone
       (``group_by("l_partkey")``, 200,000 slots): ``compile.agg.device``
       and one K1 launch each, groups against numpy; the mask and the
       epilogue timed apart;
    3. micro-batched serving through a paused server (submit the burst,
       then ``start()``): B1 64 point lookups with distinct keys (one K1b
       launch, N = 64), B2 16 range filters over order key and ship date
       (one K1b launch, N = 16), B3 8 copies of J1 (one ``join_agg``
       dispatch: one K2 or K2p launch); every ticket against numpy and the
       same query's ``collect()``.

    Launch and path counts start from zero before each step."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.compile.cache import pipeline_cache
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache, prepare_resident_predicate
    from hyperspace_tpu_torch.exec.scan_agg import _raw_planes, core_scan_agg, plan_plane_names, \
        scan_agg_plan
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    import torch

    on_card = session.device.type == "cuda"
    one = 1 if on_card else 0
    session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
    session.conf.set("hyperspace.serve.tenant.defaultMaxQueue", 256)
    if not on_card:  # a rehearsal: the zone gate would route small tables away
        session.conf.set("hyperspace.torch.hbm.maxBlockFrac", 1.0)
    t0 = time.perf_counter()
    if not hsp.prefetch_index("li_idx", SERVE_COLS):
        raise AssertionError("serve: prefetch_index(li_idx) did not make the index resident")
    hbm_cache.wait_background()
    fence(session.device)
    table = next(t for t in hbm_cache._tables if set(SERVE_COLS) <= set(t.columns))
    out = {"prefetch_s": time.perf_counter() - t0, "resident_mb": round(table.nbytes / 1e6, 1)}
    log(f"serve: prefetch_index(li_idx, {len(SERVE_COLS)} columns) {out['prefetch_s']:.3f} s, "
        f"{out['resident_mb']} MB, tier {table.tier}")
    rng = np.random.default_rng(seed + 30)
    ok = L["l_orderkey"]
    top = int(ok.max())

    # 1. compiled scans, twice
    def round_queries(r):
        keys = r.choice(np.unique(ok), 20, replace=False)
        lo = top // 6 + int(r.integers(0, top // 12))
        hi, d_lo = lo + top // 3, DAY_1995_03_15 - 365 - int(r.integers(0, 60))
        price = 50_000.0 + float(r.integers(0, 5000))
        q = [(col("l_orderkey") == int(k), ok == k) for k in keys]
        q += [((col("l_orderkey") >= lo) & (col("l_orderkey") < hi) & (col("l_quantity") < 24)
               & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15),
               (ok >= lo) & (ok < hi) & (L["l_quantity"] < 24) & (L["l_shipdate"] >= d_lo)
               & (L["l_shipdate"] < DAY_1995_03_15))] * 5
        q += [((col("l_orderkey") >= lo) & (col("l_orderkey") < hi)
               & (col("l_extendedprice") > price),
               (ok >= lo) & (ok < hi) & (L["l_extendedprice"] > price))] * 5
        return q

    rounds = []
    for i in range(2):
        qs = round_queries(np.random.default_rng(seed + 40 + i))
        reset_launch_counts()
        metrics.reset()
        t = time.perf_counter()
        res = [li.filter(p).select(*LI_RESIDENT).collect() for p, _m in qs]
        fence(session.device)
        wall = time.perf_counter() - t
        launches, m = launch_counts(), metrics.snapshot()
        for j, ((_p, mask), r) in enumerate(zip(qs, res)):
            _check(f"serve compiled round {i} [{j}]", r, LI_RESIDENT, [L[c][mask] for c in LI_RESIDENT])
        rec = {"s": wall, "queries": len(qs), "runs": m.get("compile.run.scan", 0),
               "hits": m.get("compile.cache.hit", 0), "misses": m.get("compile.cache.miss", 0),
               "k1c": launches.get(tk.K1C, 0), "fused": m.get("compile.fused.dispatches", 0)}
        if rec["runs"] != len(qs) or rec["fused"] != len(qs) or rec["k1c"] != one * len(qs) or \
                (i == 1 and (rec["misses"] or rec["hits"] != len(qs))) or \
                m.get("scan.path.resident_device") != len(qs):
            raise AssertionError(f"serve compiled round {i}: {rec}, launches {launches}")
        rounds.append(rec)
        log(f"serve compiled scans round {i} ({'fresh literals' if i else 'first'}): "
            f"{len(qs)} queries {wall:.4f} s compile.run.scan={rec['runs']} pipeline cache "
            f"hits={rec['hits']} misses={rec['misses']} K1c={rec['k1c']} "
            f"compile.fused.dispatches={rec['fused']} | rows match numpy")
    out["compiled"] = rounds
    out["pipelines"] = pipeline_cache.snapshot()

    # 2. agg_scan on the card
    lo_k, hi_k, d_lo = range_bounds(L)
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    w_mask = ((ok >= lo_k) & (ok < hi_k) & (L["l_shipdate"] >= d_lo)
              & (L["l_shipdate"] < DAY_1995_03_15))
    qty, price, ship = L["l_quantity"][w_mask], L["l_extendedprice"][w_mask], L["l_shipdate"][w_mask]
    uniq, inv = np.unique(qty, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    sums = np.bincount(inv, weights=price, minlength=len(uniq))
    mins = np.full(len(uniq), np.iinfo(np.int32).max, dtype=np.int32)
    maxs = np.full(len(uniq), np.iinfo(np.int32).min, dtype=np.int32)
    np.minimum.at(mins, inv, ship)
    np.maximum.at(maxs, inv, ship)
    q17_lo, q17_hi = top // 4, top // 4 + top // 3
    q17_mask = (ok >= q17_lo) & (ok < q17_hi)
    pk, pinv = np.unique(L["l_partkey"][q17_mask], return_inverse=True)
    pinv = pinv.reshape(-1)
    pcnt = np.bincount(pinv, minlength=len(pk)).astype(np.int64)
    aggs = {
        "A3_q1_shape": (
            li.filter(window).group_by("l_quantity").agg(
                hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"),
                hs.agg_min("l_shipdate"), hs.agg_max("l_shipdate"), hs.agg_count()),
            window, ["l_quantity"],
            {"l_quantity": uniq, "sum_l_extendedprice": sums, "avg_l_extendedprice": sums / cnt,
             "min_l_shipdate": mins, "max_l_shipdate": maxs, "count": cnt}),
        "Q17_inner": (
            li.filter((col("l_orderkey") >= q17_lo) & (col("l_orderkey") < q17_hi))
            .group_by("l_partkey").agg(hs.agg_avg("l_quantity"), hs.agg_count()),
            (col("l_orderkey") >= q17_lo) & (col("l_orderkey") < q17_hi), ["l_partkey"],
            {"l_partkey": pk, "avg_l_quantity": np.bincount(
                pinv, weights=L["l_quantity"][q17_mask].astype(np.float64),
                minlength=len(pk)) / pcnt, "count": pcnt}),
    }
    out["agg_scan"] = {}
    for name, (df, pred, keys, want) in aggs.items():
        res, t_q, launches, m, _t = timed_query(session, f"serve {name}", profile, df)
        _check_agg(f"serve {name}", res, keys, want)
        if m.get("compile.agg.device") != 1 or m.get("compile.run.agg_scan") != 1 or \
                launches.get(tk.K1, 0) != one or sum(launches.values()) != one or \
                any(k.startswith("compile.agg.declined") for k in m):
            raise AssertionError(f"serve {name}: launches {launches}, counters {m}")
        # the device aggregate's two parts, timed apart on the same inputs
        agg_node = df.optimized_plan()
        plan, _r = scan_agg_plan(table, list(agg_node.group_by), list(agg_node.aggs))
        narrowed, names = prepare_resident_predicate(table.columns, pred)
        mask_planes = _raw_planes(table, names)
        value_planes = _raw_planes(table, plan_plane_names(plan))

        def mask_fn():
            return tk.predicate_mask_tensor(narrowed, names, mask_planes)

        mask = mask_fn()
        live = mask & (torch.arange(table.n_pad, device=mask.device) < table.n_rows)
        rec = {"s": t_q, "groups": res.num_rows, "span": plan.span, "launches": launches}
        if on_card:
            rec["mask_ms"] = time_ms(mask_fn)
            rec["epilogue_ms"] = time_ms(
                lambda: core_scan_agg(plan, live, value_planes[0], value_planes[1:]))
            n_out = 1 + sum(len(c.ops) for c in plan.cols)
            rec["mask_bound_ms"], rec["mask_bound_by"] = bound(
                4 * len(names) * table.n_pad + table.n_pad, 0.0)
            rec["epilogue_bound_ms"], rec["epilogue_bound_by"] = bound(
                table.n_pad + 4 * len(value_planes) * table.n_pad + 8 * n_out * (plan.span + 1),
                0.0)
        out["agg_scan"][name] = rec
        log(f"serve agg_scan {name}: {t_q:.4f} s groups={res.num_rows} span={plan.span} "
            f"compile.agg.device=1 launches={launches} | mask ms={_fmt(rec.get('mask_ms'))} "
            f"(bound {_fmt(rec.get('mask_bound_ms'))}) epilogue ms={_fmt(rec.get('epilogue_ms'))} "
            f"(bound {_fmt(rec.get('epilogue_bound_ms'))}) | matches numpy")
        del mask_planes, value_planes, mask, live

    # 3. micro-batched serving through a paused server
    keys = rng.choice(np.unique(ok), 64, replace=False)
    bursts = {"B1_point_N64": [(li.filter(col("l_orderkey") == int(k)).select(*LI_RESIDENT),
                                ok == k) for k in keys]}
    b2 = []
    for i in range(16):
        lo = int(rng.integers(1, top - top // 10))
        d = int(rng.integers(DAY_1992_01_01, DAY_1998_08_02 - 400))
        b2.append((li.filter((col("l_orderkey") >= lo) & (col("l_orderkey") < lo + top // 10)
                             & (col("l_shipdate") >= d) & (col("l_shipdate") < d + 365))
                   .select(*LI_RESIDENT),
                   (ok >= lo) & (ok < lo + top // 10) & (L["l_shipdate"] >= d)
                   & (L["l_shipdate"] < d + 365)))
    bursts["B2_range_N16"] = b2
    j1 = q17_shape(li, od)
    j1.collect()  # a region missing here (--phases without join) is built now
    hbm_cache.wait_background()
    bursts["B3_j1_x8"] = [(q17_shape(li, od), None) for _ in range(8)]
    j1_want = q17_truth(L, O)
    out["bursts"] = {}
    for name, items in bursts.items():
        serial = [df.collect() for df, _m in items]
        reset_launch_counts()
        metrics.reset()
        server = QueryServer(session, ServeConfig(max_workers=4, max_queue=256, batch_max=64,
                                                  autostart=False))
        t = time.perf_counter()
        tickets = [server.submit(df) for df, _m in items]
        server.start()
        got = [tk_.result(timeout=600) for tk_ in tickets]
        fence(session.device)
        wall = time.perf_counter() - t
        launches, m = launch_counts(), metrics.snapshot()
        stats = server.stats()
        server.close()
        n = len(items)
        for i, ((_df, mask), r, s_r) in enumerate(zip(items, got, serial)):
            if mask is None:
                _check_agg(f"serve {name}[{i}]", r, ["l_partkey"], j1_want)
                _check_agg(f"serve {name}[{i}] collect", s_r, ["l_partkey"], j1_want)
            else:
                want = [L[c][mask] for c in LI_RESIDENT]
                _check(f"serve {name}[{i}]", r, LI_RESIDENT, want)
                _check(f"serve {name}[{i}] collect", s_r, LI_RESIDENT, want)
        if name.startswith("B3"):
            k2_l = launches.get(tk.K2, 0) + launches.get(tk.K2P, 0)
            ok_counts = (m.get("scan.path.resident_join_agg") == n and k2_l == one
                         and m.get("serve.batch.coalesced") == n)
        else:
            ok_counts = (launches.get(tk.K1B, 0) == one and launches.get(tk.K1C, 0) == 0
                         and m.get("serve.batch.dispatches") == 1
                         and m.get("serve.batch.queries") == n)
        if not ok_counts or stats["batch_size_hist"] != {n: 1} or stats["completed"] != n:
            raise AssertionError(f"serve {name}: launches {launches}, hist "
                                 f"{stats['batch_size_hist']}, counters {m}")
        rec = {"queries": n, "wall_s": wall, "qps": n / wall, "launches": launches,
               "batch_size_hist": stats["batch_size_hist"],
               "batch_dispatches": stats["batch_dispatches"],
               "latency_p50_ms": stats.get("latency_p50_ms"),
               "latency_p99_ms": stats.get("latency_p99_ms"),
               "batch_device_s": metrics.timings().get("serve.batch.device", (0.0, 0))[0]}
        out["bursts"][name] = rec
        log(f"serve burst {name}: {n} queries in {wall:.4f} s ({rec['qps']:.1f} queries/s) | "
            f"batch_size_hist={rec['batch_size_hist']} dispatches={rec['batch_dispatches']} "
            f"p50={rec['latency_p50_ms']} ms p99={rec['latency_p99_ms']} ms | launches {launches} "
            f"| every ticket matches numpy and collect()")
    out["launches_k1b"] = sum(b["launches"].get(tk.K1B, 0) for b in out["bursts"].values())
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    session.conf.unset("hyperspace.torch.hbm.maxBlockFrac")
    return out


JOIN_WARM = 10  # warm J1 calls per residency setting (J2: JOIN_WARM_J2)
JOIN_WARM_J2 = 3


def join_phase(session, li, od, q3, q3_want, L: dict, O: dict, profile: bool = False) -> dict:
    """Join residency and the join caches, in the main path's session with
    residency ``auto`` (``force`` off the card), over li_idx and ord_idx,
    each query with launch counts from zero:

    * J1 ``q17_shape`` (the aggregate phase's A1): the first call takes
      the host arm — its ranges from the ranges cache where A1 ran before
      in this process, else the presorted route with K2 and K2F once and
      no argsort — and schedules the join region (the raw region's build
      launches K2F once more for its fences, counted once the build is
      done); after
      ``wait_background`` the warm calls take ``scan.path.resident_join_agg``,
      each one K2p launch (forDelta on), no K2, no upload;
    * J2, the unfiltered join ``li.join(od).select(l_orderkey,
      l_extendedprice, o_orderdate)``, 6,001,215 rows: once with residency
      off (the host arm: its ranges from K2, or from the ranges cache on
      the second round, then the C++ gather), then warm calls through
      ``scan.path.resident_join``, one K2p launch each;
    * J3, the main path's Q3 (filtered sides) twice from an empty setup
      cache: declined as filtered, K2 once and the C++ gather; the repeat
      hits the groups, setup and ranges caches (no K2);
    * J1 and J2 again with ``hyperspace.residency.forDelta`` off from a
      reset cache: raw codes, one K2 launch a warm call, no K2p.

    Every result is held against numpy (group sums to rtol 1e-9)."""
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.exec import joins
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.exec.join_residency import join_region_key
    from hyperspace_tpu_torch.ops import launch_counts
    from hyperspace_tpu_torch.ops.kernels import K2, K2F, K2P
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    native.reset_call_counts()
    on_card = session.device.type == "cuda"
    mode = "auto" if on_card else "force"
    one = 1 if on_card else 0
    session.conf.set("hyperspace.torch.hbm.mode", mode)
    q17_want = q17_truth(L, O)
    j2 = li.join(od, col("l_orderkey") == col("o_orderkey")).select(
        "l_orderkey", "l_extendedprice", "o_orderdate")
    pos = np.searchsorted(O["o_orderkey"], L["l_orderkey"])  # orders keys ascend
    j2_cols = ["l_orderkey", "l_extendedprice", "o_orderdate"]
    j2_want = [L["l_orderkey"], L["l_extendedprice"], O["o_orderdate"][pos]]
    out = {"launches_k2p": 0}  # K2p's launches over the warm calls with forDelta on

    entries = {e.name: e for e in session.collection_manager.get_indexes()}
    l_files = entries["li_idx"].content.files()
    r_files = entries["ord_idx"].content.files()
    key_s = []
    for _ in range(5):
        t = time.perf_counter()
        join_region_key(l_files, r_files, ["l_orderkey"], ["o_orderkey"])
        key_s.append(time.perf_counter() - t)
    out["region_key_s"] = {"median": float(np.median(key_s)), "max": max(key_s),
                           "files": len(l_files) + len(r_files)}
    log(f"join: join_region_key over {len(l_files) + len(r_files)} files: median "
        f"{np.median(key_s):.6f} s max {max(key_s):.6f} s")

    def run(label, df):
        return timed_query(session, f"join {label}", profile, df)

    def region_row(label):
        snap = hbm_cache.snapshot_joins()
        if snap["regions"] != 1:
            raise AssertionError(f"join {label}: {snap['regions']} regions resident")
        return snap["per_region"][0]

    for for_delta in ("on", "off"):
        session.conf.set("hyperspace.residency.forDelta", for_delta)
        route, k_res = ("k2p", K2P) if for_delta == "on" else ("k2", K2)
        tag = f"forDelta={for_delta}"
        rec = out[f"for_delta_{for_delta}"] = {}
        if for_delta == "off":
            hbm_cache.reset()  # the regions again from nothing, raw this time
        # J1: the first call takes the host arm and schedules the region,
        # whose build on another thread launches K2F for the raw route's
        # fences, before or after the query returns: the launches are read
        # once the build is done
        res, t_host, _launches, m, _t = run(f"J1 {tag} first", q17_shape(li, od))
        _check_agg(f"join J1 {tag} first", res, ["l_partkey"], q17_want)
        hbm_cache.wait_background()
        launches = launch_counts()
        region_fences = one if route == "k2" else 0
        arms = join_arms(m)
        if m.get("join.ranges_cache.hit"):
            first_ok = arms == {"join.ranges_cache.hit": 1} and launches.get(K2, 0) == 0
        else:
            first_ok = (arms == {"join.path.presorted_merge_flat": 1}
                        and (launches.get(K2, 0), launches.get(K2F, 0))
                        == (one, one + region_fences))
        if not first_ok or m.get("aggregate.path.join_fused_native") != 1 or \
                m.get("scan.path.resident_join_agg"):
            raise AssertionError(f"join J1 {tag} first call: launches {launches}, counters {m}")
        build_s = metrics.timings().get("hbm.join.prefetch", (0.0, 0))[0]
        reg = region_row(f"J1 {tag}")
        if reg["route"] != route or "l_partkey" not in reg["payload"]:
            raise AssertionError(f"join J1 {tag}: region {reg}")
        rec["j1"] = {"host_s": t_host, "ranges_cache_hit": bool(m.get("join.ranges_cache.hit")),
                     "first_launches": launches, "first_arms": arms, "build_s": build_s,
                     "region": reg}
        times, keys = [], []
        for i in range(JOIN_WARM):
            res, t_q, launches, m, tm = run(f"J1 {tag} warm", q17_shape(li, od))
            _check_agg(f"join J1 {tag} warm {i}", res, ["l_partkey"], q17_want)
            want_l = {k_res: one} if on_card else {}
            if m.get("scan.path.resident_join_agg") != 1 or launches != want_l or \
                    m.get("hbm.join.h2d_bytes"):
                raise AssertionError(f"join J1 {tag} warm: launches {launches}, counters {m}")
            times.append(t_q)
            keys.append(tm.get("hbm.join.region_key", (0.0, 0))[0])
            out["launches_k2p"] += launches.get(K2P, 0)
        rec["j1"].update(resident_median_s=float(np.median(times)), resident_max_s=max(times),
                         warm_launches=launches, region_key_s=float(np.median(keys)),
                         device_s=tm.get("scan.resident_join_agg.device", (0.0, 0))[0])
        j = rec["j1"]
        log(f"join J1 q17_shape {tag}: host arm {j['host_s']:.4f} s (ranges cache hit "
            f"{j['ranges_cache_hit']}, launches {j['first_launches']}, arms {j['first_arms']}) | "
            f"region {reg['route']} {reg['mb']} MB (right codes raw {reg['raw_mb']} MB) built "
            f"{build_s:.3f} s | resident x{JOIN_WARM} median {j['resident_median_s']:.4f} s max "
            f"{j['resident_max_s']:.4f} s, launches {launches} each, device {j['device_s']:.4f} "
            f"s, join_region_key {j['region_key_s']:.6f} s | {res.num_rows}-group table matches "
            f"numpy")

        # J2: the host arm once (residency off; the first round from an
        # empty setup cache, so K2 runs), then warm resident calls
        session.conf.set("hyperspace.torch.hbm.mode", "off")
        if for_delta == "on":
            joins.reset_setup_cache()
        res, t_host, launches, m, _t = run(f"J2 {tag} host", j2)
        session.conf.set("hyperspace.torch.hbm.mode", mode)
        _check(f"join J2 {tag} host", res, j2_cols, j2_want)
        arms = join_arms(m)
        if res.num_rows != len(L["l_orderkey"]) or sum(arms.values()) != 1 or \
                (launches.get(K2, 0), launches.get(K2F, 0)) != (k2_of_arms(arms, on_card),) * 2 \
                or (for_delta == "on" and arms != {"join.path.presorted_merge_flat": 1}) or \
                expand_arms(m) != {"join.path.native_smj_gather": 1}:
            raise AssertionError(f"join J2 {tag} host: {res.num_rows} rows, launches {launches}, "
                                 f"counters {m}")
        j2_host_arms = arms
        times = []
        for i in range(JOIN_WARM_J2):
            res, t_q, launches, m, _t = run(f"J2 {tag} warm", j2)
            if i in (0, JOIN_WARM_J2 - 1):
                _check(f"join J2 {tag} warm {i}", res, j2_cols, j2_want)
            want_l = {k_res: one} if on_card else {}
            if m.get("scan.path.resident_join") != 1 or launches != want_l or \
                    m.get("hbm.join.h2d_bytes") or res.num_rows != len(L["l_orderkey"]):
                raise AssertionError(f"join J2 {tag} warm: launches {launches}, counters {m}")
            times.append(t_q)
            out["launches_k2p"] += launches.get(K2P, 0)
        rec["j2"] = {"host_s": t_host, "host_arms": j2_host_arms, "rows": res.num_rows,
                     "resident_median_s": float(np.median(times)), "resident_max_s": max(times),
                     "warm_launches": launches,
                     "device_s": _t.get("scan.resident_join.device", (0.0, 0))[0]}
        j = rec["j2"]
        log(f"join J2 materializing {tag}: host arm {j['host_s']:.4f} s (ranges "
            f"{list(j['host_arms'])}, C++ gather) | resident "
            f"x{JOIN_WARM_J2} median {j['resident_median_s']:.4f} s max "
            f"{j['resident_max_s']:.4f} s, launches {launches} each, ranges on the card "
            f"{j['device_s']:.4f} s | {res.num_rows} rows match numpy")

    # J3: the main path's Q3, filtered sides: declined, the caches serve
    session.conf.set("hyperspace.residency.forDelta", "on")
    q3_cols = ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate",
               "o_totalprice"]
    j3 = []
    joins.reset_setup_cache()
    for i in range(2):
        res, t_q, launches, m, _t = run(f"J3 q3 {i}", q3)
        _check(f"join J3 {i}", res, q3_cols, q3_want)
        arms = join_arms(m)
        want_arms, want_k2 = (({"join.path.presorted_merge_flat": 1}, one) if i == 0
                              else ({"join.ranges_cache.hit": 1}, 0))
        if m.get("hbm.join.declined.filtered") != 1 or launches.get(K2, 0) != want_k2 or \
                arms != want_arms or expand_arms(m) != {"join.path.native_smj_gather": 1}:
            raise AssertionError(f"join J3 {i}: launches {launches}, counters {m}")
        if i == 1 and (m.get("join.cache.hit") != 2 or m.get("join.setup_cache.hit") != 1):
            raise AssertionError(f"join J3 repeat: cache counters {m}")
        j3.append({"s": t_q, "launches": launches, "groups_cache_hit": m.get("join.cache.hit", 0),
                   "setup_cache_hit": m.get("join.setup_cache.hit", 0),
                   "ranges_cache_hit": m.get("join.ranges_cache.hit", 0)})
    out["j3"] = j3
    log(f"join J3 q3 (filtered): declined as filtered | {j3[0]['s']:.4f} s (K2 "
        f"{j3[0]['launches'].get(K2, 0)}) then {j3[1]['s']:.4f} s with groups cache hits "
        f"{j3[1]['groups_cache_hit']}, setup cache hits {j3[1]['setup_cache_hit']} and ranges "
        f"cache hits {j3[1]['ranges_cache_hit']} (K2 {launches.get(K2, 0)}) | C++ gather | "
        f"matches numpy")
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    out["native_calls"] = native.call_counts()
    log(f"join: native calls {out['native_calls']}")
    return out


# ---------------------------------------------------------------------------
# native phase: the C++ runtime's entries at the main path's sizes
# ---------------------------------------------------------------------------
NATIVE_REPEATS = 5  # timed calls of each native entry (median)
PLAIN_REPEATS = 3  # timed calls of each plain version (median)


def host_ms(fn, repeats: int):
    """(median wall ms of ``repeats`` calls, the last call's result)."""
    times, res = [], None
    for _ in range(repeats):
        t = time.perf_counter()
        res = fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), res


def _max_abs_err(got, want) -> float:
    """0.0 where ``got`` and ``want`` are equal bit for bit, else raise:
    every native entry is held exactly against its plain version."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape or got.tobytes() != want.tobytes():
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64)) if \
            got.shape == want.shape else np.inf
        raise AssertionError(f"native entry differs from its plain version: max abs err "
                             f"{np.max(diff) if np.size(diff) else diff}")
    return 0.0


def _files_by_bucket(files, columns) -> dict:
    """{bucket: batch} of per-bucket index files, read through
    ``read_batches`` (the native loads)."""
    from hyperspace_tpu_torch.storage import layout

    files = sorted(files)
    return {layout.bucket_of_file(f): b
            for f, b in zip(files, layout.read_batches(files, columns=columns))}


def _touch_pages(batches) -> int:
    """Fault in every page of mmap-backed columns (one byte a page)."""
    return sum(int(np.asarray(c.data).view(np.uint8)[::4096].sum())
               for b in batches for c in b.columns.values())


def _evict(files) -> int:
    """Drop ``files`` from the page cache (fsync, then
    ``POSIX_FADV_DONTNEED``), after the reader cache's maps, which pin the
    pages they touched; returns how many files then have some page out of
    the cache."""
    from hyperspace_tpu_torch.storage import layout

    with layout._READER_CACHE_LOCK:
        layout._READER_CACHE.clear()
    gc.collect()
    out = 0
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        mm = np.memmap(f, dtype=np.uint8, mode="r")
        out += not layout.pages_cached(mm, 0, len(mm))
        del mm
    return out


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def native_phase(session, L: dict, workdir: Path) -> dict:
    """Each entry of the native runtime (``hyperspace_tpu_torch/native``,
    built by g++ from ``native/tcb_io.cc``) at the main path's sizes over
    li_idx and ord_idx, in the main path's session, timed (median wall of
    5 calls) against its plain version — the port's numpy arm of the same
    step (3 calls) — on the same inputs, and held against it bit for bit:

    * ``hs_pread_many``: ``read_batches``' pread arm over li_idx's 200
      files, every column, in the page cache, against mmap views with
      every page touched; then the 400-file read of li_idx and ord_idx,
      native and plain in turns (past the reader cache's 256 handles, so
      every read maps its files anew), with the files in the page cache
      and evicted before each read where the host lets a file be evicted,
      ``read_batches`` choosing the mmap arm for the first and pread for
      the second, with the bytes it
      allocates and the process's resident growth;
    * ``hs_expand_gather``: J2's gather (li_idx's l_orderkey and
      l_extendedprice, ord_idx's o_orderkey and o_orderdate, 6,001,215
      pairs) from K2's ranges, against ``_expand_ranges`` + ``take``;
    * ``hs_expand_pairs``: the same ranges into pair arrays, against
      ``_expand_ranges``;
    * ``hs_group_agg_ranges_f64``/``_i64``: A1's 6,001,215 left rows into
      200,000 l_partkey slots over o_totalprice and o_custkey, against the
      generic arm's steps (the right value per left row, then bincount or
      ``np.add.at``);
    * ``hs_write_file_atomic``: one li_idx file written anew, against
      Python's write, fsync and rename.

    The SF3 range walk where K2 declines is the streaming phase's
    (``sf3_range_walk``). Calls made here are no path's."""
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.exec import joins
    from hyperspace_tpu_torch.storage import layout

    entries = {e.name: e for e in session.collection_manager.get_indexes()}
    li_files = sorted(entries["li_idx"].content.files())
    od_files = sorted(entries["ord_idx"].content.files())
    out = {}

    # hs_pread_many: li_idx's 200 files, then li_idx and ord_idx's 400
    def plain_read(files):
        batches = [layout.read_batch(f) for f in files]
        _touch_pages(batches)
        return batches

    def native_read(files):
        batches = layout.load_buffers(layout.read_plan(files))
        _touch_pages(batches)
        return batches

    t_plain, mm = host_ms(lambda: plain_read(li_files), PLAIN_REPEATS)
    t_nat, got = host_ms(lambda: native_read(li_files), NATIVE_REPEATS)
    err = max(_max_abs_err(g.columns[n].data, m.columns[n].data)
              for g, m in zip(got, mm) for n in m.column_names)
    n_bytes = sum(c.data.nbytes for b in got for c in b.columns.values())
    del got, mm
    # 400 files pass the reader cache's 256 handles: each read maps its
    # files anew. In the page cache (warm), then evicted before every read
    # (cold), in turns, plain, native, native, plain; read_batches itself
    # serves the cold native turns and must choose hs_pread_many there,
    # and the mmap arm on the warm files
    both = li_files + od_files
    native.reset_call_counts()
    _touch_pages(layout.read_batches(both))
    if native.call_counts().get("hs_pread_many", 0):
        raise AssertionError("native phase: read_batches read 400 cached files by pread")
    plan = layout.read_plan(both)
    t_check, _ = host_ms(lambda: [layout.pages_cached(rd._raw, 0, len(rd._raw))
                                  for rd, _names, _metas in plan], NATIVE_REPEATS)
    del plan
    t400 = {"warm": {"plain": [], "native": []}, "cold": {"plain": [], "native": []}}
    evicted = []
    for temp in ("warm", "cold"):
        for arm in ("plain", "native", "native", "plain"):
            if temp == "cold":
                evicted.append(_evict(both))
                if not evicted[-1]:
                    break  # a page cache that keeps every page: no cold read here
            native.reset_call_counts()
            rss0 = _rss_bytes()
            t = time.perf_counter()
            if arm == "plain":
                res = plain_read(both)
            elif temp == "warm":
                res = native_read(both)
            else:
                res = layout.read_batches(both)
                _touch_pages(res)
            t400[temp][arm].append((time.perf_counter() - t) * 1e3)
            if temp == "cold" and arm == "native" and evicted[-1] == len(both) \
                    and native.call_counts().get("hs_pread_many") != 1:
                raise AssertionError("native phase: read_batches mapped 400 evicted files")
            if arm == "native":
                b400 = sum(c.data.nbytes for b in res for c in b.columns.values())
                rss400 = _rss_bytes() - rss0
            del res
    out["hs_pread_many"] = {
        "replaces": "storage/layout.py:read_batches' mmap arm", "rows": int(len(L["l_orderkey"])),
        "shape": f"li_idx: {len(li_files)} files, 5 columns, {n_bytes} bytes, in the page cache",
        "ms": t_nat, "plain_ms": t_plain, "max_abs_err": err,
        "read_400_files": {"warm": t400["warm"], "cold": t400["cold"], "files_evicted": evicted,
                           "page_cache_test_ms": t_check, "bytes": b400,
                           "rss_growth_bytes": rss400}}

    # J2's and A1's join: li_idx and ord_idx by bucket, K2's ranges
    lmap = _files_by_bucket(li_files, ["l_orderkey", "l_partkey", "l_extendedprice"])
    rmap = _files_by_bucket(od_files, ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"])
    setup, _key = joins._bucketed_join_setup(lmap, rmap, ["l_orderkey"], ["o_orderkey"])
    l_all, r_all, l_codes, r_codes, lb, rb, presorted = setup
    if presorted != (True, True):
        raise AssertionError(f"native phase: li_idx and ord_idx not presorted {presorted}")
    ranges = joins._cached_smj_ranges(None, l_codes, r_codes, lb, rb, presorted, session.device)
    lo, cnt, _off, total = ranges
    l_data = {n: l_all.columns[n].data for n in ("l_orderkey", "l_extendedprice")}
    r_data = {n: r_all.columns[n].data for n in ("o_orderkey", "o_orderdate")}

    def plain_gather():
        li, ri = joins._expand_ranges(lo, cnt, None)
        return ({n: a[li] for n, a in l_data.items()}, {n: a[ri] for n, a in r_data.items()})

    t_plain, want = host_ms(plain_gather, PLAIN_REPEATS)
    t_nat, got = host_ms(lambda: native.smj_join_gather(
        l_codes, r_codes, lb, rb, l_data, r_data, ranges=ranges), NATIVE_REPEATS)
    err = max(_max_abs_err(got[side][n], want[side][n]) for side in (0, 1) for n in want[side])
    out["hs_expand_gather"] = {
        "replaces": "exec/joins.py:_expand_ranges + ColumnarBatch.take", "rows": int(total),
        "shape": f"J2: {len(lo)} left rows, 2 + 2 columns", "ms": t_nat, "plain_ms": t_plain,
        "max_abs_err": err}
    del got, want
    t_plain, want = host_ms(lambda: joins._expand_ranges(lo, cnt, None), PLAIN_REPEATS)
    t_nat, got = host_ms(lambda: native.expand_pairs(lo, cnt, ranges), NATIVE_REPEATS)
    out["hs_expand_pairs"] = {
        "replaces": "exec/joins.py:_expand_ranges", "rows": int(total),
        "shape": f"J2: {len(lo)} left rows", "ms": t_nat, "plain_ms": t_plain,
        "max_abs_err": max(_max_abs_err(g, w) for g, w in zip(got, want))}
    del got, want

    # A1: l_partkey slots over o_totalprice (f64) and o_custkey (i64)
    if int(cnt.max()) > 1:
        raise AssertionError("native phase: A1's right side is not unique")
    keys = l_all.columns["l_partkey"].data.astype(np.int64)
    keys = keys - keys.min()
    span = int(keys.max()) + 1
    hit = cnt > 0
    pos = np.where(hit, lo, 0)
    for entry, name in (("hs_group_agg_ranges_f64", "o_totalprice"),
                        ("hs_group_agg_ranges_i64", "o_custkey")):
        vals = r_all.columns[name].data

        def plain_agg():
            v = vals[pos]
            if vals.dtype.kind == "f":
                ok = hit & ~np.isnan(v)
                sums = np.bincount(keys, weights=np.where(ok, v, 0.0), minlength=span)
            else:
                ok = hit
                sums = np.zeros(span, dtype=np.int64)
                np.add.at(sums, keys, np.where(ok, v, 0))
            nn = np.bincount(keys, weights=ok, minlength=span).astype(np.int64)
            rows = np.bincount(keys, weights=cnt, minlength=span).astype(np.int64)
            return sums, nn, rows

        t_plain, want = host_ms(plain_agg, PLAIN_REPEATS)
        t_nat, got = host_ms(lambda: native.group_agg_ranges(keys, lo, cnt, vals, span),
                             NATIVE_REPEATS)
        out[entry] = {
            "replaces": "exec/aggregate.py:aggregate_join_ranges' generic arm",
            "rows": int(len(keys)), "shape": f"A1: {len(keys)} left rows into {span} slots, "
            f"{name}", "ms": t_nat, "plain_ms": t_plain,
            "max_abs_err": max(_max_abs_err(g, w) for g, w in zip(got, want))}

    # hs_write_file_atomic: one li_idx file written anew
    data = Path(li_files[0]).read_bytes()
    dst = workdir / "native_write"
    dst.mkdir(exist_ok=True)

    def plain_write():
        tmp = dst / ".plain.tcb.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst / "plain.tcb")

    t_plain, _ = host_ms(plain_write, PLAIN_REPEATS)
    t_nat, _ = host_ms(lambda: native.write_file_atomic(str(dst / "native.tcb"), data),
                       NATIVE_REPEATS)
    out["hs_write_file_atomic"] = {
        "replaces": "Python's write, fsync and os.replace", "rows": len(data),
        "shape": f"one li_idx file, {len(data)} bytes", "ms": t_nat, "plain_ms": t_plain,
        "max_abs_err": _max_abs_err(np.frombuffer((dst / "native.tcb").read_bytes(), np.uint8),
                                    np.frombuffer((dst / "plain.tcb").read_bytes(), np.uint8))}
    for entry, rec in out.items():
        log(f"native {entry}: {rec['shape']} | native {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms ({rec['replaces']}) | max_abs_err {rec['max_abs_err']}")
    r4 = out["hs_pread_many"]["read_400_files"]
    for temp in ("warm", "cold"):
        if not r4[temp]["native"]:
            log(f"native read of li_idx and ord_idx's 400 files, {temp}: not measurable on this "
                f"host (fsync and POSIX_FADV_DONTNEED evicted no file)")
            continue
        log(f"native read of li_idx and ord_idx's 400 files, {temp}, in turns: native (pread) "
            f"{[round(t, 3) for t in r4[temp]['native']]} ms, plain (mmap, every page touched) "
            f"{[round(t, 3) for t in r4[temp]['plain']]} ms")
    log(f"native read of 400 files: files evicted before each cold turn {r4['files_evicted']} "
        f"| page cache test (mincore) over the 400 files {r4['page_cache_test_ms']:.3f} ms | "
        f"{r4['bytes']} bytes loaded, resident growth {r4['rss_growth_bytes']} bytes")
    return out


def sf3_range_walk(l_files, r_files, device) -> dict:
    """``hs_smj_ranges`` at SF3 where K2 declines: li and orders' 200
    per-bucket files each (18,003,645 and 4,500,000 order keys), the flat
    codes K2's plan declines, the native walk against the host search
    that served them before (``np.searchsorted`` x2), bit for bit."""
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.exec import joins
    from hyperspace_tpu_torch.ops import kernels as tk

    setup, _key = joins._bucketed_join_setup(
        _files_by_bucket(l_files, ["l_orderkey"]), _files_by_bucket(r_files, ["o_orderkey"]),
        ["l_orderkey"], ["o_orderkey"])
    _l_all, _r_all, l_codes, r_codes, lb, rb, presorted = setup
    if presorted != (True, True):
        raise AssertionError(f"native SF3 walk: sides not presorted {presorted}")
    l_flat, r_flat = joins._flat_segment_remap(l_codes, r_codes, lb, rb)
    declines = tk.sorted_intersect_counts(l_flat, r_flat, device) is None

    def plain():
        lo = np.searchsorted(r_flat, l_flat, side="left")
        return lo, np.searchsorted(r_flat, l_flat, side="right") - lo

    t_plain, want = host_ms(plain, PLAIN_REPEATS)
    t_nat, got = host_ms(lambda: native.smj_ranges(l_codes, r_codes, lb, rb), NATIVE_REPEATS)
    rec = {"replaces": "exec/joins.py:segmented_join_ranges' host search",
           "rows": int(len(l_codes)), "shape": f"SF3: {len(l_codes)} left x {len(r_codes)} "
           f"right keys in {len(lb) - 1} segments, K2 declines: {declines}",
           "ms": t_nat, "plain_ms": t_plain, "k2_declines": declines,
           "max_abs_err": max(_max_abs_err(g, w) for g, w in zip(got, want))}
    log(f"native hs_smj_ranges: {rec['shape']} | native {t_nat:.3f} ms, plain {t_plain:.3f} ms "
        f"({rec['replaces']}) | max_abs_err {rec['max_abs_err']}")
    return rec


def cpu_model() -> str:
    """The host CPU's model name, with its vendor, family and model
    numbers (a virtual machine may report the name as "unknown")."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key in ("model name", "vendor_id", "cpu family", "model") and key not in fields:
                    fields[key] = val.strip()
                if not line.strip() and fields:
                    break
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')}, family "
            f"{fields.get('cpu family', '?')}, model {fields.get('model', '?')})")


def native_line(main_out: dict, stream_out) -> dict:
    """The ``native:`` line: each entry's calls on the main, aggregate,
    join and streaming paths (None where the path did not run), its times
    against its plain version and its error, with the host's CPU."""
    calls = {"main": main_out.get("native_calls"),
             "aggregate": (main_out.get("aggregate") or {}).get("native_calls"),
             "join": (main_out.get("join") or {}).get("native_calls"),
             "streaming": (stream_out or {}).get("native_calls")}
    timed = dict(main_out.get("native") or {})
    if stream_out is not None:
        timed["hs_smj_ranges"] = stream_out["native_walk"]
    out = []
    for entry in ("hs_pread_many", "hs_smj_ranges", "hs_expand_pairs", "hs_expand_gather",
                  "hs_group_agg_ranges_f64", "hs_group_agg_ranges_i64", "hs_write_file_atomic"):
        rec = timed.get(entry, {})
        out.append({"entry": entry, "source": "hyperspace_tpu_torch/native/tcb_io.cc",
                    "calls": {p: (None if c is None else c.get(entry, 0))
                              for p, c in calls.items()},
                    "rows": rec.get("rows"), "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
                    "max_abs_err": rec.get("max_abs_err")})
    return {"entries": out, "cpu_count": os.cpu_count(), "cpu_model": cpu_model()}


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
    it to li_idx and ord_idx, and its first run must run through K2 and
    the C++ gather. (2) lineitem
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
    from hyperspace_tpu_torch.exec import joins
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
    # its first run from an empty setup cache: the hand-placed Q3's cached
    # ranges would otherwise serve it without K2
    joins.reset_setup_cache()
    reset_launch_counts()
    metrics.reset()
    nat, t_nat = timed("natural Q3", natural)
    launches = launch_counts()
    want_k2 = 1 if on_card else 0
    arms = join_arms(metrics.snapshot())
    if (launches.get(K2, 0), launches.get(K2F, 0)) != (want_k2, want_k2) or \
            arms != {"join.path.presorted_merge_flat": 1} or \
            expand_arms(metrics.snapshot()) != {"join.path.native_smj_gather": 1}:
        raise AssertionError(f"natural Q3 did not run the bucketed join's presorted route "
                             f"through K2 and the C++ gather: launches {launches}, arms {arms}")
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


JOIN_ARMS = ("join.path.presorted_merge_flat", "join.path.presorted_merge",
             "join.path.device_kernel", "join.path.host_searchsorted",
             "join.path.native_smj_ranges", "join.ranges_cache.hit")
EXPAND_ARMS = ("join.path.native_smj_gather", "join.path.native_expand_pairs")


def join_arms(m: dict) -> dict:
    """Where a query's bucketed join took its match ranges
    (``exec/joins.py``): the presorted route (K2 over flat-remapped
    codes), the native walk where K2's plan declines and both sides are
    ascending, the host search or the per-segment host loop where only
    the right side is, the argsort route (K2), or the ranges cache."""
    return {k: m[k] for k in JOIN_ARMS if m.get(k)}


def expand_arms(m: dict) -> dict:
    """How a materializing join expanded its ranges in C++: fused with the
    output gather (both sides presorted) or into pair arrays."""
    return {k: m[k] for k in EXPAND_ARMS if m.get(k)}


def k2_of_arms(arms: dict, on_card: bool) -> int:
    """K2 launches (and fence builds) a query's join arms imply: one for
    an arm that runs K2 on the card, none for the host arms."""
    return int(on_card) * sum(arms.get(k, 0) for k in ("join.path.presorted_merge_flat",
                                                       "join.path.device_kernel"))


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
    on: the SF1 rows (``own_source``) as ``src/lineitem_lc`` (8 avro files) and
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
    li_dir, how = own_source(workdir, "lineitem_lc", lineitem, LINEITEM_SCHEMA, 8, "lineitem")
    od_dir, _how = own_source(workdir, "orders_lc", orders, ORDERS_SCHEMA, 2, "orders")
    out = {"write_s": time.perf_counter() - t0, "rf1_orders": n_new,
           "rf1_lineitems": {k: len(li["l_orderkey"]) for k, (li, _od) in batches.items()},
           "steps": []}
    log(f"lifecycle: sources {how} in {out['write_s']:.3f} s; RF1 batches of {n_new} "
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

    truths = {}  # numpy's answers, by the batches present (steps share them)

    def truth():
        key = tuple(present)
        if key not in truths:
            L = {c: np.concatenate([p[0][c] for p in present.values()]) for c in lineitem}
            O = {c: np.concatenate([p[1][c] for p in present.values()]) for c in orders}
            truths[key] = range_and_q3_truth(L, O, bounds, "lifecycle")
        return truths[key]

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
            arms = join_arms(m3)
            bucketed = rewritten and sum(arms.values()) == 1
            want_k2 = k2_of_arms(arms, on_card) if rewritten else l3.get(K2, 0)
            if (l3.get(K2, 0), l3.get(K2F, 0)) != (want_k2, want_k2) or (rewritten and not bucketed) \
                    or (on_card and rewritten and not want_k2):
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
    on, 200 buckets, residency off): the SF1 rows (``own_source``) as
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
    li_dir, how = own_source(workdir, "lineitem_hy", lineitem, LINEITEM_SCHEMA, 8, "lineitem")
    od_dir, _how = own_source(workdir, "orders_hy", orders, ORDERS_SCHEMA, 2, "orders")
    out = {"write_s": time.perf_counter() - t0, "steps": []}
    log(f"hybrid: sources {how} in {out['write_s']:.3f} s")
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

    truths = {}  # numpy's answers, by the parts present (steps share them)

    def truth():
        key = (tuple(li_parts), tuple(od_parts))
        if key not in truths:
            L = {c: np.concatenate([p[c] for p in li_parts.values()]) for c in lineitem}
            O = {c: np.concatenate([p[c] for p in od_parts.values()]) for c in orders}
            truths[key] = range_and_q3_truth(L, O, bounds, "hybrid")
        return truths[key]

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
                arms = join_arms(m)
                if (launches.get(tk.K2, 0), launches.get(tk.K2F, 0)) != (want_k2, want_k2) or \
                        sum(arms.values()) != 1 or k2_of_arms(arms, on_card) != want_k2:
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

    def hybrid_burst(n: int = 16) -> dict:
        """A burst of ``n`` range filters (the range filter's widths over
        other order keys) through a paused server while li_hy's base and
        its delta are resident: one K1hb launch serves the batch, base,
        delta and deletion mask at once; every ticket against numpy."""
        from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts
        from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
        from hyperspace_tpu_torch.telemetry.metrics import metrics

        session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
        lo_k, hi_k, d_lo = bounds
        L = {c: np.concatenate([p[c] for p in li_parts.values()]) for c in lineitem}
        r = np.random.default_rng(seed + 50)
        items = []
        for _ in range(n):
            lo = int(r.integers(1, int(L["l_orderkey"].max()) - (hi_k - lo_k)))
            b = (lo, lo + hi_k - lo_k, d_lo)
            m = ((L["l_orderkey"] >= b[0]) & (L["l_orderkey"] < b[1]) & (L["l_quantity"] < 24)
                 & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))
            items.append((range_and_q3(session, li_dir, od_dir, b)[0], [L[c][m] for c in R_COLS]))
        reset_launch_counts()
        metrics.reset()
        server = QueryServer(session, ServeConfig(max_workers=4, autostart=False))
        t = time.perf_counter()
        tickets = [server.submit(df) for df, _w in items]
        server.start()
        got = [x.result(timeout=600) for x in tickets]
        fence(session.device)
        wall = time.perf_counter() - t
        launches, m = launch_counts(), metrics.snapshot()
        stats = server.stats()
        server.close()
        for i, (res, (_df, want)) in enumerate(zip(got, items)):
            _check(f"hybrid H2 burst [{i}]", res, R_COLS, want)
        one = 1 if on_card else 0
        if launches.get(tk.K1HB, 0) != one or launches.get(tk.K1H, 0) or \
                m.get("scan.path.resident_hybrid") != n or stats["batch_size_hist"] != {n: 1} \
                or m.get("serve.batch.dispatches") != 1:
            raise AssertionError(f"hybrid H2 burst: launches {launches}, hist "
                                 f"{stats['batch_size_hist']}, counters {m}")
        session.conf.set("hyperspace.torch.hbm.mode", "off")
        rec = {"queries": n, "wall_s": wall, "qps": n / wall, "launches": launches,
               "batch_size_hist": stats["batch_size_hist"],
               "latency_p50_ms": stats.get("latency_p50_ms"),
               "latency_p99_ms": stats.get("latency_p99_ms")}
        log(f"hybrid H2 burst: {n} range filters in {wall:.4f} s ({rec['qps']:.1f} queries/s) | "
            f"batch_size_hist={rec['batch_size_hist']} launches {launches} "
            f"p50={rec['latency_p50_ms']} ms p99={rec['latency_p99_ms']} ms | every ticket "
            f"matches numpy")
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
    out["h2_burst"] = hybrid_burst()

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
            m.get("aggregate.path.join_fused_native", 0) != 1:
        raise AssertionError(f"hybrid H-agg: launches {launches}, counters {m}")
    moved = m.get("union.repartition.rows", 0)
    out["h_agg"] = {"s": t_q, "groups": res.num_rows, "launches": launches,
                    "join_fused_native": m.get("aggregate.path.join_fused_native", 0),
                    "union_repartition_rows": moved,
                    "aggregate_join_ranges_s": times.get("aggregate.join_ranges", (0.0, 0))[0],
                    "join_bucketed_ranges_s": times.get("join.bucketed_ranges", (0.0, 0))[0]}
    log(f"hybrid H-agg q17_shape: {t_q:.4f} s groups={res.num_rows} join_fused_native=1 "
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
# reliability phase: crash recovery, storage weather, fencing, the device
# probe and device loss mid-burst
# ---------------------------------------------------------------------------
REL_LEASE_S = 2.0  # hyperspace.reliability.lease.durationSeconds of the phase
# the device-loss degrade counters: a run counts them per phase, and only
# the reliability phase, which injects the loss, may move them
DEGRADE_COUNTERS = ("scan.resident.device_failed", "scan.resident_join.device_failed",
                    "residency.stream.window_failed", "serve.degraded", "shuffle.device_failed",
                    "scan.resident_mesh.device_failed")
_DEGRADES = dict.fromkeys(DEGRADE_COUNTERS, 0)


def watch_degrades() -> None:
    """Tally the degrade counters as the port records them, apart from the
    registry (which phases reset). Idempotent."""
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    real = metrics.incr
    if getattr(real, "watches_degrades", False):
        return

    def incr(name, n=1):
        if name in _DEGRADES:
            _DEGRADES[name] += int(n)
        real(name, n)

    incr.watches_degrades = True
    metrics.incr = incr


def degrade_guard(phase: str) -> dict:
    """Fail the run where a phase other than reliability degraded: on the
    card a degrade nobody injected is a fault, never a quiet re-route."""
    got = dict(_DEGRADES)
    if any(got.values()):
        raise AssertionError(f"{phase}: device-loss degrades nobody injected: {got}")
    log(f"{phase}: degrade counters {got}")
    return got


@contextmanager
def _log_fs(fs):
    """The collection manager's log managers over ``fs`` (the way the
    reference's chaos tests put a fault file system under a verb)."""
    from hyperspace_tpu_torch.index import collection_manager as cm
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl

    orig = cm.IndexCollectionManager._log_manager
    cm.IndexCollectionManager._log_manager = lambda self, name: IndexLogManagerImpl(
        self.path_resolver.get_index_path(name), fs=fs, retry_policy=self.conf.retry_policy())
    try:
        yield
    finally:
        cm.IndexCollectionManager._log_manager = orig


def reliability_phase(lineitem, orders, workdir: Path, device: str, seed: int,
                      profile: bool = False) -> dict:
    """Reliability at SF1, in its own session: indexes li_rel and ord_rel
    (200 buckets) under their own system path with a 2 s writer lease, over
    the main path's avro source (written here when the workdir lacks it).

    R1 a crashed create: li_rel's create runs over a fault file system
       that kills the process at the final log entry (create_if_absent
       #2), so the data is written and the head is CREATING; once the
       lease expires a new session's first listing rolls it back
       (recovery.auto_rollback = 1); doctor() reports the torn version
       directory, doctor(repair=True) vacuums it and a rescan is clean;
       the create runs again and commits; the range filter (K1 per file)
       and Q3 against ord_rel (K2 + K2F) return numpy's rows;
    R2 storage weather: one RF1 batch of orders appended, ord_rel's full
       refresh runs with every log call failing once (transient) under the
       retrying file system; it commits, and storage.retry.attempts equals
       the faults injected;
    R3 a fenced zombie: a delete whose heartbeat stops is overtaken by a
       forced cancel; its end raises LeaseFencedError, the log stays as the
       cancel wrote it, lease.fenced_writer_refused = 1;
    R4 the device probe: first_device_touch_ok() is True, its ms and the
       latched verdict; a fresh touch timed apart;
    R5 device loss mid-burst: li_rel prefetched, B1's 64 point lookups
       through a paused one-worker server whose batched launch raises a
       RuntimeError on its first call; every ticket returns numpy's rows,
       stats() shows degraded with the injected reason, serve.degraded =
       1, the table is dropped and the lookups launched K1 per file; a
       fresh server after a re-prefetch serves the burst with one K1b
       launch, not degraded."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.actions.metadata_actions import DeleteAction
    from hyperspace_tpu_torch.exceptions import LeaseFencedError
    from hyperspace_tpu_torch.exec.hbm_cache import HbmIndexCache, hbm_cache
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops.kernels import K1, K1B, K1C, K2, K2F
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.reliability import (
        FaultInjectingFileSystem, FaultRule, InjectedCrash, LeaseManager, crash_at, doctor)
    from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch
    from hyperspace_tpu_torch.storage.filesystem import PosixFileSystem
    from hyperspace_tpu_torch.telemetry.metrics import metrics
    from hyperspace_tpu_torch.utils import deviceprobe

    on_card = device == "cuda"
    one = int(on_card)
    t_phase = time.perf_counter()
    L, O = lineitem, orders
    li_dir, od_dir = workdir / "src" / "lineitem", workdir / "src" / "orders"
    if not (li_dir.is_dir() and od_dir.is_dir()):
        li_dir = Path(write_avro_dir(li_dir, L, LINEITEM_SCHEMA, 8))
        od_dir = Path(write_avro_dir(od_dir, O, ORDERS_SCHEMA, 2))
    root = workdir / "indexes_rel"
    conf = {"hyperspace.system.path": str(root),
            "hyperspace.index.numBuckets": NUM_BUCKETS,
            "hyperspace.index.build.mode": "inmemory",
            "hyperspace.torch.device": device,
            "hyperspace.torch.hbm.mode": "off",
            "hyperspace.serve.tenant.defaultMaxQueue": 256,
            "hyperspace.reliability.lease.durationSeconds": REL_LEASE_S}

    def new_session():
        s = hs.HyperspaceSession(hs.HyperspaceConf(dict(conf)))
        return s, hs.Hyperspace(s)

    def li_config():
        return hs.IndexConfig("li_rel", ["l_orderkey"],
                              ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"])

    out = {"steps_s": {}}
    session, hsp = new_session()

    # R1: a crashed create, recovered on the next session's listing
    t = time.perf_counter()
    hsp.create_index(session.read.avro(str(od_dir)), hs.IndexConfig(
        "ord_rel", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_totalprice"]))
    split = {"ord_rel_create_s": time.perf_counter() - t}
    t1 = time.perf_counter()
    fault = FaultInjectingFileSystem(PosixFileSystem(), [crash_at("create_if_absent", 2)])
    try:
        with _log_fs(fault):
            hsp.create_index(session.read.avro(str(li_dir)), li_config())
        raise AssertionError("reliability R1: the create did not die at its final entry")
    except InjectedCrash:
        pass
    split["crashed_create_s"] = time.perf_counter() - t1
    li_path = root / "li_rel"
    log_mgr = IndexLogManagerImpl(li_path)
    head = log_mgr.get_latest_log().state
    lease = LeaseManager(li_path, PosixFileSystem())
    waited = time.perf_counter()
    while not lease.current().is_abandoned():  # the dead writer's lease runs out
        if time.perf_counter() - waited > 10 * REL_LEASE_S:
            raise AssertionError(f"reliability R1: lease {lease.current()} never expired")
        time.sleep(0.05)
    waited = time.perf_counter() - waited
    t1 = time.perf_counter()
    metrics.reset()
    session, hsp = new_session()
    listed = [i.name for i in hsp.indexes()]
    rollbacks = metrics.get("recovery.auto_rollback")
    states = [log_mgr.get_log(i).state for i in range(log_mgr.get_latest_id() + 1)]
    before = doctor(root)
    repaired = doctor(root, repair=True)
    after = doctor(root)
    kinds = sorted({i.kind for i in before.issues})
    if head != "CREATING" or rollbacks != 1 or listed != ["ord_rel"] or \
            states[-1] != "DOESNOTEXIST" or "orphan-version-dir" not in kinds or \
            not all(i.repaired for i in repaired.issues if i.repairable) or not after.ok \
            or after.issues:
        raise AssertionError(f"reliability R1: head {head} rollbacks {rollbacks} listed {listed} "
                             f"states {states} doctor {kinds} -> {after.to_json_dict()}")
    split["recover_and_doctor_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    hsp.create_index(session.read.avro(str(li_dir)), li_config())
    split["create_again_s"] = time.perf_counter() - t1
    if log_mgr.get_latest_log().state != "ACTIVE":
        raise AssertionError("reliability R1: the second create did not commit")
    session.enable_hyperspace()
    bounds = range_bounds(L)
    want_r, want_q3 = range_and_q3_truth(L, O, bounds, "reliability")
    rng_q, q3_q = range_and_q3(session, li_dir, od_dir, bounds)
    res, t_r, l_r, m_r, _t = timed_query(session, "reliability R1 range", profile, rng_q)
    _check("reliability R1 range filter", res, R_COLS, want_r)
    res3, t_q3, l_q3, m_q3, _t = timed_query(session, "reliability R1 Q3", profile, q3_q)
    _check("reliability R1 Q3", res3, Q3_COLS, want_q3)
    read = m_r.get("scan.files_read", 0)
    want_k2 = k2_of_arms(join_arms(m_q3), on_card)
    if l_r.get(K1, 0) != one * read or not read or (l_q3.get(K2, 0), l_q3.get(K2F, 0)) != (
            want_k2, want_k2) or (on_card and want_k2 != 1):
        raise AssertionError(f"reliability R1: range launches {l_r} files read {read}, Q3 "
                             f"launches {l_q3} arms {join_arms(m_q3)}")
    out["steps_s"]["R1"] = time.perf_counter() - t
    out["R1"] = {"head": head, "lease_wait_s": waited, **split, "auto_rollback": rollbacks,
                 "states": states, "doctor_before": kinds,
                 "doctor_repaired": sorted({i.kind for i in repaired.issues if i.repaired}),
                 "doctor_after": sorted({i.kind for i in after.issues}), "doctor_after_ok": after.ok,
                 "range_s": t_r, "range_rows": res.num_rows, "q3_s": t_q3, "q3_rows": res3.num_rows,
                 "launches": {"range": l_r, "q3": l_q3}}
    log(f"reliability R1 crashed create: head {head}, lease expired after {waited:.3f} s, the "
        f"next session's listing rolled it back (recovery.auto_rollback={rollbacks}, states "
        f"{states}) | doctor {kinds} -> repaired {out['R1']['doctor_repaired']} -> rescan ok="
        f"{after.ok} | create again committed | range filter {t_r:.4f} s rows={res.num_rows} "
        f"launches {l_r} | Q3 {t_q3:.4f} s rows={res3.num_rows} launches {l_q3} | "
        f"{out['steps_s']['R1']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + ") | matches numpy")

    # R2: a full refresh through storage weather
    t = time.perf_counter()
    n_new = max(1, int(round(1500 * len(O["o_orderkey"]) / SF1_ORDERS)))
    _li_new, od_new = rf1_batches(O, seed + 17, n_new, n_batches=1)[0]
    rf1_file = od_dir / "part-rel-rf1.avro"
    write_avro(rf1_file, ColumnarBatch.from_pydict(od_new, schema=ORDERS_SCHEMA))
    weather = FaultRule(kind="fail", op="*", every=2)
    metrics.reset()
    with _log_fs(FaultInjectingFileSystem(PosixFileSystem(), [weather])):
        hsp.refresh_index("ord_rel", "full")
    ord_mgr = IndexLogManagerImpl(root / "ord_rel")
    attempts = metrics.get("storage.retry.attempts")
    if attempts != weather._fired or not attempts or metrics.get("storage.retry.exhausted") or \
            ord_mgr.get_latest_log().state != "ACTIVE" or not doctor(root).ok:
        raise AssertionError(f"reliability R2: retries {attempts}, faults {weather._fired}, "
                             f"state {ord_mgr.get_latest_log().state}")
    out["steps_s"]["R2"] = time.perf_counter() - t
    out["R2"] = {"faults": weather._fired, "retry_attempts": attempts,
                 "retry_by_op": {k: v for k, v in metrics.snapshot().items()
                                 if k.startswith("storage.retry.") and k != "storage.retry.attempts"}}
    log(f"reliability R2 storage weather: RF1 {n_new} orders appended, ord_rel's full refresh "
        f"committed with {weather._fired} log calls failed once each, "
        f"storage.retry.attempts={attempts} {out['R2']['retry_by_op']} | "
        f"{out['steps_s']['R2']:.3f} s")

    # R3: a stalled writer fenced by a forced cancel
    t = time.perf_counter()
    zombie = DeleteAction(IndexLogManagerImpl(root / "ord_rel"), session.conf)
    zombie.validate()
    zombie._begin()
    zombie._held_lease._stop.set()  # the writer stalls: no heartbeat
    zombie._held_lease._thread.join(5.0)
    hsp.cancel("ord_rel")
    cancelled = [ord_mgr.get_log(i).state for i in range(ord_mgr.get_latest_id() + 1)]
    metrics.reset()
    try:
        zombie._end()
        raise AssertionError("reliability R3: the fenced writer committed")
    except LeaseFencedError as e:
        fenced_msg = str(e)
    states = [ord_mgr.get_log(i).state for i in range(ord_mgr.get_latest_id() + 1)]
    refused = metrics.get("lease.fenced_writer_refused")
    if states != cancelled or states[-3:] != ["DELETING", "CANCELLING", "ACTIVE"] or refused != 1:
        raise AssertionError(f"reliability R3: states {states} after cancel {cancelled}, "
                             f"refused {refused}")
    out["steps_s"]["R3"] = time.perf_counter() - t
    out["R3"] = {"states": states[-3:], "fenced_writer_refused": refused}
    log(f"reliability R3 fenced zombie: a delete with its heartbeat stopped, overtaken by a "
        f"forced cancel; its end raised LeaseFencedError ({fenced_msg}); log tail "
        f"{states[-3:]} as the cancel wrote it; lease.fenced_writer_refused={refused} | "
        f"{out['steps_s']['R3']:.3f} s")

    # R4: the device probe
    t = time.perf_counter()
    ok = deviceprobe.first_device_touch_ok(device=device)
    probe_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    deviceprobe._touch(device)
    touch_ms = 1e3 * (time.perf_counter() - t)
    if ok is not True or deviceprobe.latched_verdict() is not True:
        raise AssertionError(f"reliability R4: probe {ok}, latched {deviceprobe.latched_verdict()}"
                             f", error {deviceprobe.first_touch_error()}")
    out["steps_s"]["R4"] = (probe_ms + touch_ms) / 1e3
    out["R4"] = {"ok": ok, "probe_ms": probe_ms, "touch_ms": touch_ms,
                 "latched": deviceprobe.latched_verdict()}
    log(f"reliability R4 device probe: first_device_touch_ok()={ok} in {probe_ms:.3f} ms "
        f"(latched verdict {deviceprobe.latched_verdict()}); a fresh 16-element round trip and "
        f"synchronize {touch_ms:.3f} ms")

    # R5: device loss mid-burst
    t = time.perf_counter()
    session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
    if not on_card:  # a rehearsal: the zone gate would route small tables away
        session.conf.set("hyperspace.torch.hbm.maxBlockFrac", 1.0)

    def prefetch():
        if not hsp.prefetch_index("li_rel", LI_RESIDENT):
            raise AssertionError("reliability R5: prefetch_index(li_rel) did not make it resident")
        hbm_cache.wait_background()
        fence(session.device)

    def li_tables():
        return [x for x in hbm_cache._tables if str(li_path) in str(x.files[0])]

    ok_keys = L["l_orderkey"]
    keys = np.random.default_rng(seed + 50).choice(np.unique(ok_keys), 64, replace=False)
    li = session.read.avro(str(li_dir))
    burst = [(li.filter(col("l_orderkey") == int(k)).select(*LI_RESIDENT), ok_keys == k)
             for k in keys]
    real = HbmIndexCache.block_counts_batch
    lost = []

    def lossy(self, *a, **k):
        if not lost:
            lost.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was encountered "
                               "(injected by chip_smoke R5)")
        return real(self, *a, **k)

    rounds = {}
    for name in ("loss", "fresh"):
        prefetch()
        reset_launch_counts()
        metrics.reset()
        if name == "loss":
            HbmIndexCache.block_counts_batch = lossy
        try:
            server = QueryServer(session, ServeConfig(max_workers=1, max_queue=256, batch_max=64,
                                                      autostart=False))
            t1 = time.perf_counter()
            tickets = [server.submit(df) for df, _m in burst]
            server.start()
            got = [tk_.result(timeout=600) for tk_ in tickets]
            fence(session.device)
            wall = time.perf_counter() - t1
            stats = server.stats()
            server.close()
        finally:
            HbmIndexCache.block_counts_batch = real
        launches, m = launch_counts(), metrics.snapshot()
        for i, ((_df, mask), r) in enumerate(zip(burst, got)):
            _check(f"reliability R5 {name}[{i}]", r, LI_RESIDENT, [L[c][mask] for c in LI_RESIDENT])
        rounds[name] = {"wall_s": wall, "launches": launches, "degraded": stats["degraded"],
                        "degraded_reason": stats["degraded_reason"],
                        "serve_degraded": m.get("serve.degraded", 0),
                        "files_read": m.get("scan.files_read", 0), "completed": stats["completed"],
                        "batch_size_hist": stats["batch_size_hist"],
                        "tables_after": len(li_tables())}
    loss, fresh = rounds["loss"], rounds["fresh"]
    if not (loss["degraded"] and "injected by chip_smoke R5" in (loss["degraded_reason"] or "")
            and loss["serve_degraded"] == 1 and loss["completed"] == 64
            and loss["tables_after"] == 0 and loss["files_read"] >= 64
            and loss["launches"].get(K1, 0) == one * loss["files_read"]
            and not loss["launches"].get(K1B, 0) and not loss["launches"].get(K1C, 0)):
        raise AssertionError(f"reliability R5 loss: {loss}")
    if fresh["degraded"] or fresh["launches"].get(K1B, 0) != one or fresh["launches"].get(K1, 0) \
            or fresh["batch_size_hist"] != {64: 1} or fresh["completed"] != 64:
        raise AssertionError(f"reliability R5 fresh server: {fresh}")
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    session.conf.unset("hyperspace.torch.hbm.maxBlockFrac")
    hbm_cache.reset()
    rf1_file.unlink()
    out["steps_s"]["R5"] = time.perf_counter() - t
    out["R5"] = rounds
    log(f"reliability R5 device loss mid-burst: 64 point lookups, the batched launch raised on "
        f"its first call; {loss['completed']} tickets answered in {loss['wall_s']:.4f} s, "
        f"degraded={loss['degraded']} ({loss['degraded_reason']}), serve.degraded="
        f"{loss['serve_degraded']}, li_rel tables left {loss['tables_after']}, per-file route "
        f"files read {loss['files_read']} launches {loss['launches']} | fresh server after a "
        f"re-prefetch: {fresh['wall_s']:.4f} s hist {fresh['batch_size_hist']} launches "
        f"{fresh['launches']} degraded={fresh['degraded']} | every ticket matches numpy")
    out["launches"] = {K1: l_r.get(K1, 0) + loss["launches"].get(K1, 0),
                       K2: l_q3.get(K2, 0), K2F: l_q3.get(K2F, 0),
                       K1B: fresh["launches"].get(K1B, 0)}
    out["counters"] = {"recovery.auto_rollback": rollbacks, "storage.retry.attempts": attempts,
                       "lease.fenced_writer_refused": refused,
                       "serve.degraded": loss["serve_degraded"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log("reliability: " + json.dumps({
        "steps_s": out["steps_s"], "counters": out["counters"],
        "doctor": {"before": kinds, "after": out["R1"]["doctor_after"]},
        "probe_ms": probe_ms, "touch_ms": touch_ms,
        "launches": {"R1_range": l_r, "R1_q3": l_q3, "R5_loss": loss["launches"],
                     "R5_fresh": fresh["launches"]},
        "phase_s": out["phase_s"]}))
    return out


# ---------------------------------------------------------------------------
# mesh phase: the bucket mesh, 4 shards on one card
# ---------------------------------------------------------------------------
MESH_SHARDS = 4
MESH_LI_COLS = ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]
MESH_OD_COLS = ["o_custkey", "o_orderdate", "o_totalprice"]


def _renamed_index_file(data: bytes, name: str) -> bytes:
    """An index file's bytes with its footer's ``indexName`` set to
    ``name``: the bytes the build writes for the same rows under that
    index name (the footer is the writer's ``json.dumps``)."""
    from hyperspace_tpu_torch.storage.layout import MAGIC

    end = len(data) - len(MAGIC) - 8
    n = int.from_bytes(data[end:end + 8], "little")
    footer = json.loads(data[end - n:end])
    footer["extra"]["indexName"] = name
    fb = json.dumps(footer).encode("utf-8")
    return data[:end - n] + fb + len(fb).to_bytes(8, "little") + MAGIC


def _bucket_files(index_dir: Path) -> dict:
    from hyperspace_tpu_torch.storage import layout

    return {layout.bucket_of_file(f): f for f in sorted((index_dir / "v__=0").glob("*.tcb"))}


def _same_index_bytes(mesh_dir: Path, single_dir: Path, name: str) -> int:
    """Every file of the mesh-built index against the single-device
    build's file of the same bucket, byte for byte (its footer's index
    name set to the mesh index's). Returns the files compared."""
    got, want = _bucket_files(mesh_dir), _bucket_files(single_dir)
    if sorted(got) != sorted(want):
        raise AssertionError(f"mesh M1: {name} holds buckets {len(got)}, the single-device "
                             f"build {len(want)}")
    for b, f in got.items():
        if f.read_bytes() != _renamed_index_file(want[b].read_bytes(), name):
            raise AssertionError(f"mesh M1: {name} bucket {b} differs from the single-device "
                                 f"build's file {want[b].name}")
    return len(got)


def q1_shape_truth(L: dict, window_mask: np.ndarray) -> dict:
    """numpy's A3 ``q1_shape``: the window's rows grouped by l_quantity,
    groups ascending."""
    qty, price, ship = (L["l_quantity"][window_mask], L["l_extendedprice"][window_mask],
                        L["l_shipdate"][window_mask])
    uniq, inv = np.unique(qty, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    s = np.bincount(inv, weights=price, minlength=len(uniq))
    mins = np.full(len(uniq), np.iinfo(np.int32).max, dtype=np.int32)
    maxs = np.full(len(uniq), np.iinfo(np.int32).min, dtype=np.int32)
    np.minimum.at(mins, inv, ship)
    np.maximum.at(maxs, inv, ship)
    return {"l_quantity": uniq, "sum_l_extendedprice": s, "avg_l_extendedprice": s / cnt,
            "min_l_shipdate": mins, "max_l_shipdate": maxs, "count": cnt}


# NVIDIA's H100 SXM data sheet: PCIe Gen5 x16, 128 GB/s both ways
PCIE_BYTES_PER_S = 64e9


def mesh_programs(mesh, L: dict, root: Path, bounds, repeats: int = 3) -> dict:
    """Each mesh program of the reference alone, at the mesh phase's shapes,
    its inputs in host memory: seconds (median of ``repeats`` host-clock
    calls, each ending in a fence), launches (the last call), the bytes it
    moves between host and card, and the least time the link allows them
    (the larger direction over ``PCIE_BYTES_PER_S``): the sharded build of
    lineitem (``_sharded_build_fn``), the range filter's per-shard masks
    (``_dist_mask_fn``), A3's partial aggregates (``_dist_agg_fn``), Q3's
    per-shard ranges (``_dist_join_fn``) and the move of Q3's orders side
    from ord_m64 into 200 buckets (``_shuffle_fn``)."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.distributed.shuffle import repartition_by_bucket
    from hyperspace_tpu_torch.exec import distributed as dist
    from hyperspace_tpu_torch.exec.executor import Executor
    from hyperspace_tpu_torch.ops import build as tbuild
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.plan.expr import col, eval_mask
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    def groups(name, cols, pred=None):
        files = sorted((root / name / "v__=0").glob("*.tcb"))
        g = Executor._read_groups_by_bucket(files, cols)
        if pred is not None:
            g = {b: v.take(np.flatnonzero(eval_mask(pred, v))) for b, v in g.items()}
            g = {b: v for b, v in g.items() if v.num_rows}
        return g

    lo_k, hi_k, d_lo = bounds
    rng_pred = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k) & (col("l_quantity") < 24)
                & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    li_cols = ["l_orderkey"] + MESH_LI_COLS
    li_batch = ColumnarBatch.from_pydict({c: L[c] for c in li_cols},
                                         schema={c: LINEITEM_SCHEMA[c] for c in li_cols})
    li_groups = groups("li_mesh", R_COLS)
    q3_l = groups("li_mesh", ["l_orderkey", "l_extendedprice", "l_shipdate"],
                  col("l_shipdate") > DAY_1993_06_01)
    q3_r = groups("ord_mesh", ["o_orderkey", "o_orderdate", "o_totalprice"],
                  col("o_orderdate") < DAY_1995_03_15)
    q3_r64 = groups("ord_m64", ["o_orderkey", "o_orderdate", "o_totalprice"],
                    col("o_orderdate") < DAY_1995_03_15)
    build_h2d = sum(int(tbuild.encode_for_device(li_batch.columns[c]).nbytes) for c in li_cols)
    specs = [hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"),
             hs.agg_min("l_shipdate"), hs.agg_max("l_shipdate"), hs.agg_count()]
    programs = {
        # name: (reference program, call, (h2d, d2h) from the counters and shapes)
        "sharded_build": ("hyperspace_tpu/ops/build.py:808 _sharded_build_fn",
                          lambda: tbuild.build_partition_sharded(li_batch, ["l_orderkey"],
                                                                 NUM_BUCKETS, mesh),
                          lambda m: (build_h2d, build_h2d + 4 * li_batch.num_rows)),
        "dist_mask": ("hyperspace_tpu/exec/distributed.py:80 _dist_mask_fn",
                      lambda: dist.distributed_filter(li_groups, rng_pred, R_COLS, mesh),
                      lambda m: (m.get("dist.h2d_bytes", 0), m.get("dist.d2h_bytes", 0))),
        "dist_agg": ("hyperspace_tpu/exec/distributed.py:200 _dist_agg_fn",
                     lambda: dist.distributed_filter_aggregate(li_groups, window, ["l_quantity"],
                                                               specs, mesh),
                     lambda m: (m.get("dist.h2d_bytes", 0), m.get("dist.d2h_bytes", 0))),
        "dist_join": ("hyperspace_tpu/exec/distributed.py:495 _dist_join_fn",
                      lambda: dist.distributed_bucketed_join(q3_l, q3_r, ["l_orderkey"],
                                                             ["o_orderkey"], mesh),
                      lambda m: (m.get("dist.h2d_bytes", 0), m.get("dist.d2h_bytes", 0))),
        "shuffle": ("hyperspace_tpu/distributed/shuffle.py:70 _shuffle_fn",
                    lambda: repartition_by_bucket(q3_r64, ["o_orderkey"], NUM_BUCKETS, mesh),
                    lambda m: (m.get("shuffle.h2d_bytes", 0), m.get("shuffle.d2h_bytes", 0))),
    }
    out = {}
    for name, (ref, call, moved) in programs.items():
        secs = []
        for _ in range(repeats):
            reset_launch_counts()
            metrics.reset()
            t = time.perf_counter()
            call()
            fence(mesh.devices[0])
            secs.append(time.perf_counter() - t)
        h2d, d2h = moved(metrics.snapshot())
        rec = {"replaces": ref, "ms": statistics.median(secs) * 1e3,
               "ms_all": [x * 1e3 for x in secs], "launches": launch_counts(),
               "h2d_bytes": int(h2d), "d2h_bytes": int(d2h),
               "bound_ms": max(h2d, d2h) / PCIE_BYTES_PER_S * 1e3, "bound_by": "PCIe bytes"}
        out[name] = rec
        log(f"mesh program {name} ({ref}): {rec['ms']:.3f} ms (median of {repeats}: "
            f"{', '.join(f'{x:.3f}' for x in rec['ms_all'])}) launches {rec['launches']} "
            f"h2d {h2d} B d2h {d2h} B, bound {rec['bound_ms']:.3f} ms (PCIe bytes)")
    return out


MR_REPEATS = 3  # MR2's repeats of each filter, MR5's and MR6's warm calls
MR3_WINDOWS = 8  # MR3's streaming windows a shard (2^18 rows each at SF1)
# the reference's mesh programs the mesh cache ports, for the programs-alone lines
MESH_RESIDENT_REFS = {
    "mesh_counts": "hyperspace_tpu/exec/mesh_cache.py:198 _mesh_counts_fn",
    "mesh_batched_counts": "hyperspace_tpu/exec/mesh_cache.py:250 _mesh_batched_counts_fn",
    "mesh_hybrid_counts": "hyperspace_tpu/exec/mesh_cache.py:315 _mesh_hybrid_counts_fn",
    "mesh_upload_window": "hyperspace_tpu/residency/streaming.py:519 _mesh_upload_window",
    "mesh_stream_counts": "hyperspace_tpu/residency/streaming.py:548 mesh_stream_block_counts",
    "mesh_stream_counts_batch":
        "hyperspace_tpu/residency/streaming.py:588 mesh_stream_block_counts_batch",
    "mesh_join_agg": "hyperspace_tpu/exec/join_residency.py:1020 mesh_join_agg_fn",
    "mesh_scan_agg": "hyperspace_tpu/exec/scan_agg.py:365 mesh_scan_agg_fn",
}


def _mesh_li_table(mesh_cache, root: Path, columns):
    """The registered mesh table over li_mesh's files holding ``columns``."""
    li_files = {str(p) for p in (root / "li_mesh").glob("v__=*/*.tcb")}
    for t in reversed(mesh_cache._tables):
        if set(columns) <= set(t.columns) and {k[0] for k in t.key} == li_files:
            return t
    raise AssertionError(f"mesh: no resident table over li_mesh with {columns}")


def mesh_resident_steps(session, hsp, mesh, L: dict, O: dict, workdir: Path, root: Path,
                        li_dir: Path, od_dir: Path, bounds, step, m4, seed: int,
                        on_card: bool) -> dict:
    """MR1-MR8: the mesh phase's session and indexes with
    ``hyperspace.torch.hbm.mode`` force. Each step counts launches from 0
    (``step``) and holds its rows against numpy or the equal M step:

    MR1 ``prefetch_index(li_mesh, LI_RESIDENT)`` into the mesh cache: the
        tier, each shard's rows, ``cap``, MB, seconds and peak device
        memory; no ``hbm.mesh.*`` refusal;
    MR2 the range filter, the point lookup and a predicate on
        ``l_extendedprice`` (f64, two planes), ``MR_REPEATS`` each: K1c
        once a shard (the lookup too: the resident lookup comes before the
        row gate), ``scan.path.resident_device_mesh``, no upload;
    MR3 two fresh prefetches of the range filter's columns under budgets
        set from MR1's table: the compressed tier (K1p once a shard) and the
        streaming tier (K1p once a shard a window); the range filter's rows;
        LI_RESIDENT prefetched again after;
    MR4 A3's Q1 shape through the interpreter's resident arm (compile off:
        K1c once a shard, ``aggregate.path.resident_mesh``), then the
        compiled device aggregate (K1 once a shard, ``compile.agg.device``);
        groups equal M4's and numpy's;
    MR5 J1 (Q17's aggregate-join) over li_mesh and ord_mesh: the first call
        schedules the mesh join region; the warm calls launch K2p once a
        shard, ``scan.path.resident_join_agg_mesh``, no upload;
    MR6 ord_hy, a mesh index over a copy of the orders source (2 files,
        lineage on), one RF1 batch appended and one base file removed: the
        base prefetched, the first query's host union populating the delta,
        then a range filter through K1h once a shard,
        ``scan.path.resident_hybrid_mesh``; rows equal numpy's;
    MR7 B1's 64 point lookups through a paused server: one
        ``serve.batch.dispatches``, K1b once a shard; rows equal the single
        queries';
    MR8 MR2's range filter with the first shard's count launch raising a
        RuntimeError: ``scan.resident_mesh.device_failed`` = 1, the table
        dropped, the per-query route (K1 once a shard, an upload) answering
        with M2's rows.

    Returns the steps' records and, under ``held``, the tables, region and
    delta the programs-alone measurement reuses."""
    import torch

    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.exec.mesh_cache import mesh_cache
    from hyperspace_tpu_torch.ops import bitpack, fence
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    D = mesh.size
    dev0 = mesh.devices[0]
    out = {}
    held = {}

    def per_shard(kname):
        return {kname: D} if on_card else {}

    def fenced(fn):
        def run():
            res = fn()
            for dev in dict.fromkeys(mesh.devices):
                fence(dev)
            return res
        return run

    session.conf.set("hyperspace.torch.hbm.mode", "force")
    lo_k, hi_k, d_lo = bounds
    li = session.read.avro(str(li_dir))
    # MR1: the prefetch
    peak_before = torch.cuda.max_memory_allocated(dev0) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev0)
    ok, rec = step("MR1 prefetch", fenced(lambda: hsp.prefetch_index("li_mesh", LI_RESIDENT)))
    table = _mesh_li_table(mesh_cache, root, LI_RESIDENT)
    refused = {k: v for k, v in rec["counters"].items() if k.startswith("hbm.mesh.")
               and any(w in k for w in ("refused", "declined", "unreachable", "failed"))}
    if not ok or refused or table.tier != "resident":
        raise AssertionError(f"mesh MR1: prefetch {ok}, tier {table.tier}, refusals {refused}")
    rec.update(tier=table.tier, dev_rows=list(table.dev_rows), cap=table.cap,
               mb=table.nbytes / 1e6,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev0) if on_card else None)
    out["peak_before_mr"] = peak_before
    log(f"mesh MR1 prefetch_index(li_mesh, {LI_RESIDENT}): {rec['s']:.3f} s tier {table.tier} "
        f"rows a shard {table.dev_rows} cap {table.cap} {rec['mb']:.1f} MB, peak device memory "
        f"{rec['peak_mem_bytes']} B | no hbm.mesh refusal")

    # MR2: resident filters
    rng_want, _ = range_and_q3_truth(L, O, bounds, "mesh MR2")
    rng_q = range_and_q3(session, li_dir, od_dir, bounds)[0]
    k = int(L["l_orderkey"][len(L["l_orderkey"]) // 2])
    price = 50_000.0
    pm = (L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k) & (L["l_extendedprice"] > price)
    mr2 = {"range": (rng_q, rng_want),
           "point": (li.filter(col("l_orderkey") == k).select(*R_COLS),
                     [L[c][L["l_orderkey"] == k] for c in R_COLS]),
           "f64": (li.filter((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
                             & (col("l_extendedprice") > price)).select(*R_COLS),
                   [L[c][pm] for c in R_COLS])}
    for name, (df, want) in mr2.items():
        secs = []
        for i in range(MR_REPEATS):
            got, rec = step(f"MR2 {name} {i}", df.collect)
            _check(f"mesh MR2 {name}", got, R_COLS, want)
            c = rec["counters"]
            if (rec["launches"] != per_shard(tk.K1C) or c.get("dist.h2d_bytes")
                    or c.get("scan.path.resident_device_mesh") != 1):
                raise AssertionError(f"mesh MR2 {name} {i}: {rec}")
            secs.append(rec["s"])
        log(f"mesh MR2 {name}: {MR_REPEATS} queries {', '.join(f'{x:.4f}' for x in secs)} s "
            f"rows={got.num_rows} launches {rec['launches']} a query "
            f"scan.path.resident_device_mesh=1 dist.h2d_bytes=0 | matches numpy")

    # MR3: the lower tiers, budgets from MR1's table
    cols3 = ["l_orderkey", "l_quantity", "l_shipdate"]
    cap = table.cap
    specs = {c: bitpack.pack_spec(table.columns[c].vmin, table.columns[c].vmax, cap)
             for c in cols3}
    raw_b = 4 * D * cap * len(cols3)
    packed_b = sum(D * s.packed_nbytes if s is not None else 4 * D * cap for s in specs.values())
    W = cap // MR3_WINDOWS
    slab_b = 2 * D * sum(4 * (W // s.vpw if s is not None else W) for s in specs.values())
    # the budget the ladder sees is budgetMB less what builds and result
    # caches hold (hbm_cache._budget_bytes): those bytes ride on top
    from hyperspace_tpu_torch.residency.slabs import held_bytes
    from hyperspace_tpu_torch.residency.tiers import claimant_bytes

    extra = -(-(held_bytes() + claimant_bytes()) >> 20)
    budgets = {"compressed": ((packed_b + raw_b) // 2 >> 20) + extra,
               "streaming": (slab_b >> 20) + 2 + extra}
    if not ((budgets["streaming"] - extra) << 20) < packed_b <= (
            (budgets["compressed"] - extra) << 20) < raw_b:
        raise AssertionError(f"mesh MR3: budgets {budgets} do not separate the tiers "
                             f"(raw {raw_b} B, packed {packed_b} B, slabs {slab_b} B)")
    mesh_cache.drop(table)
    session.conf.set("hyperspace.residency.streaming.windowRows", W)
    for tier, mb in budgets.items():
        session.conf.set("hyperspace.torch.hbm.budgetMB", mb)
        ok, rec = step(f"MR3 prefetch {tier}", fenced(lambda: hsp.prefetch_index("li_mesh",
                                                                                  cols3)))
        t3 = _mesh_li_table(mesh_cache, root, cols3)
        if not ok or t3.tier != tier:
            raise AssertionError(f"mesh MR3: budget {mb} MB gave tier {t3.tier}, not {tier}")
        held[tier] = t3
        got, rq = step(f"MR3 range {tier}", rng_q.collect)
        _check(f"mesh MR3 {tier} range filter", got, R_COLS, rng_want)
        n_w = getattr(t3, "n_windows", 1)
        kname = tk.K1P if any(s is not None for s in specs.values()) else tk.K1C
        want_l = {kname: D * n_w} if on_card else {}
        c = rq["counters"]
        if (rq["launches"] != want_l or c.get("scan.path.resident_device_mesh") != 1
                or (tier == "streaming" and c.get("residency.stream.windows") != n_w)):
            raise AssertionError(f"mesh MR3 {tier}: {rq}")
        rec.update(tier=tier, budget_mb=mb, mb=t3.nbytes / 1e6, raw_mb=t3.raw_nbytes / 1e6,
                   windows=n_w)
        log(f"mesh MR3 {tier}: budgetMB {mb} (raw {raw_b} B, packed {packed_b} B, slab pairs "
            f"{slab_b} B) prefetch {rec['s']:.3f} s {rec['mb']:.1f} MB charged | range filter "
            f"{rq['s']:.4f} s launches {rq['launches']} windows {n_w} | matches numpy")
        mesh_cache.drop(t3)  # the next prefetch is a fresh one
    session.conf.unset("hyperspace.torch.hbm.budgetMB")
    session.conf.unset("hyperspace.residency.streaming.windowRows")
    ok, rec = step("MR3 prefetch LI_RESIDENT again", fenced(
        lambda: hsp.prefetch_index("li_mesh", LI_RESIDENT)))
    table = held["table"] = _mesh_li_table(mesh_cache, root, LI_RESIDENT)
    if not ok or table.tier != "resident":
        raise AssertionError(f"mesh MR3: LI_RESIDENT again: tier {table.tier}")

    # MR4: aggregates
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    w_mask = ((L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k)
              & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))
    q1 = li.filter(window).group_by("l_quantity").agg(
        hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"), hs.agg_min("l_shipdate"),
        hs.agg_max("l_shipdate"), hs.agg_count())
    q1_want = q1_shape_truth(L, w_mask)
    m4_order = np.argsort(np.asarray(m4.columns["l_quantity"].data), kind="stable")
    m4_want = {n: np.asarray(m4.columns[n].data)[m4_order] for n in m4.column_names}
    session.conf.set("hyperspace.compile.mode", "off")
    try:
        got, rec = step("MR4 q1_shape interpreter", q1.collect)
    finally:
        session.conf.unset("hyperspace.compile.mode")
    for label, want in (("numpy", q1_want), ("M4", m4_want)):
        _check_agg(f"mesh MR4 q1_shape interpreter ({label})", got, ["l_quantity"], want)
    if (rec["counters"].get("aggregate.path.resident_mesh") != 1
            or rec["launches"] != per_shard(tk.K1C)):
        raise AssertionError(f"mesh MR4 interpreter: {rec}")
    got, rec2 = step("MR4 q1_shape device", q1.collect)
    for label, want in (("numpy", q1_want), ("M4", m4_want)):
        _check_agg(f"mesh MR4 q1_shape device ({label})", got, ["l_quantity"], want)
    if (rec2["counters"].get("compile.agg.device") != 1
            or rec2["counters"].get("scan.path.resident_agg_mesh") != 1
            or rec2["launches"] != per_shard(tk.K1)):
        raise AssertionError(f"mesh MR4 device aggregate: {rec2}")
    log(f"mesh MR4 q1_shape: interpreter's resident arm {rec['s']:.4f} s launches "
        f"{rec['launches']} aggregate.path.resident_mesh=1 | compiled device aggregate "
        f"{rec2['s']:.4f} s launches {rec2['launches']} compile.agg.device=1 | groups equal "
        f"M4's and numpy's")

    # MR5: the mesh join region
    od = session.read.avro(str(od_dir))
    j1 = q17_shape(li, od)
    plan = plan_with_indexes(j1)
    if "li_mesh" not in plan or "ord_mesh" not in plan:
        raise AssertionError(f"mesh MR5: J1 is not served by li_mesh and ord_mesh:\n{plan}")
    j1_want = q17_truth(L, O)
    got, rec = step("MR5 j1 first", j1.collect)
    _check_agg("mesh MR5 j1 first", got, ["l_partkey"], j1_want)
    t = time.perf_counter()
    mesh_cache.wait_background()
    build_s = time.perf_counter() - t
    snap = mesh_cache.snapshot_joins()
    if snap["regions"] != 1:
        raise AssertionError(f"mesh MR5: {snap['regions']} regions after the first call")
    region = held["region"] = mesh_cache._joins[0]
    if on_card and set(region.routes) != {"k2p"}:
        raise AssertionError(f"mesh MR5: the shards' routes are {region.routes}, not k2p")
    k2 = tk.K2P
    warm = []
    for i in range(MR_REPEATS):
        got, rw = step(f"MR5 j1 warm {i}", j1.collect)
        _check_agg(f"mesh MR5 j1 warm {i}", got, ["l_partkey"], j1_want)
        c = rw["counters"]
        if (rw["launches"] != per_shard(k2) or c.get("scan.path.resident_join_agg_mesh") != 1
                or c.get("hbm.mesh.join.h2d_bytes") or c.get("dist.h2d_bytes")):
            raise AssertionError(f"mesh MR5 warm {i}: {rw}")
        warm.append(rw["s"])
    rec.update(region=snap["per_region"][0], build_wait_s=build_s)
    log(f"mesh MR5 j1 (q17_shape over li_mesh x ord_mesh): first {rec['s']:.4f} s (the "
        f"distributed join; schedules the region) + {build_s:.3f} s to its build's end "
        f"{snap['per_region'][0]} | warm {', '.join(f'{x:.4f}' for x in warm)} s launches "
        f"{rw['launches']} a call scan.path.resident_join_agg_mesh=1 hbm.mesh.join.h2d_bytes=0 "
        f"| groups match numpy")

    # MR6: the mesh hybrid over a copy of orders
    src = workdir / "src" / "orders_mr6"
    write_avro_dir(src, O, ORDERS_SCHEMA, 2)
    for key, v in (("hyperspace.index.lineage.enabled", True),
                   ("hyperspace.index.hybridscan.enabled", True),
                   ("hyperspace.index.hybridscan.maxDeletedRatio", 0.6)):
        session.conf.set(key, v)
    _, rec = step("MR6 build ord_hy", lambda: hsp.create_index(
        session.read.avro(str(src)), hs.IndexConfig("ord_hy", ["o_orderkey"], MESH_OD_COLS)))
    # TPC-H RF1: SF x 1,500 new orders
    new = rf1_batches(O, seed, max(1, len(O["o_orderkey"]) // 1000), 1)[0][1]
    write_avro(src / "part-rf1.avro", ColumnarBatch.from_pydict(new, schema=ORDERS_SCHEMA))
    (src / "part-001.avro").unlink()
    half = int(np.linspace(0, len(O["o_orderkey"]), 3)[1])
    kept = {c: np.concatenate([O[c][:half], new[c]]) for c in ORDERS_SCHEMA}
    top = int(O["o_orderkey"].max())
    o_lo, o_hi = top // 6, top // 2
    hy_cols = ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]
    hq = session.read.avro(str(src)).filter(
        (col("o_orderkey") >= o_lo) & (col("o_orderkey") < o_hi)
        & (col("o_orderdate") < DAY_1995_03_15)).select(*hy_cols)
    hm = ((kept["o_orderkey"] >= o_lo) & (kept["o_orderkey"] < o_hi)
          & (kept["o_orderdate"] < DAY_1995_03_15))
    hy_want = [kept[c][hm] for c in hy_cols]
    ok, rp = step("MR6 prefetch ord_hy", fenced(lambda: hsp.prefetch_index(
        "ord_hy", ["o_orderkey", "o_orderdate"])))
    got, rf = step("MR6 first", hq.collect)
    _check("mesh MR6 first (host union)", got, hy_cols, hy_want)
    t = time.perf_counter()
    mesh_cache.wait_background()
    pop_s = time.perf_counter() - t
    if not ok or mesh_cache.snapshot()["deltas"] != 1 or rf["counters"].get(
            "scan.path.resident_hybrid_mesh"):
        raise AssertionError(f"mesh MR6: prefetch {ok}, {mesh_cache.snapshot()}, first {rf}")
    delta = mesh_cache._deltas[0]
    warm = []
    for i in range(MR_REPEATS):
        got, rh = step(f"MR6 hybrid {i}", hq.collect)
        _check(f"mesh MR6 hybrid {i}", got, hy_cols, hy_want)
        if (rh["launches"] != per_shard(tk.K1H)
                or rh["counters"].get("scan.path.resident_hybrid_mesh") != 1
                or rh["counters"].get("dist.h2d_bytes")):
            raise AssertionError(f"mesh MR6 hybrid {i}: {rh}")
        warm.append(rh["s"])
    hy_table = next(t for t in mesh_cache._tables if t.key == delta.base_key)
    held["hybrid"] = (hy_table, delta, (col("o_orderkey") >= o_lo) & (col("o_orderkey") < o_hi)
                      & (col("o_orderdate") < DAY_1995_03_15))
    rec.update(delta_rows=delta.dev_rows, deleted_ids=len(delta.deleted_ids),
               delta_cap=delta.cap, populate_wait_s=pop_s)
    log(f"mesh MR6 ord_hy (2 files, lineage on; one RF1 batch of {len(new['o_orderkey'])} "
        f"orders appended, part-001 removed): build {rec['s']:.3f} s | prefetch {rp['s']:.3f} s "
        f"| first query (host union) {rf['s']:.4f} s, the delta populated {pop_s:.3f} s later "
        f"(shard rows {delta.dev_rows}, {len(delta.deleted_ids)} deleted file ids) | hybrid "
        f"{', '.join(f'{x:.4f}' for x in warm)} s launches {rh['launches']} "
        f"scan.path.resident_hybrid_mesh=1 | rows={got.num_rows} match numpy")
    for key in ("hyperspace.index.lineage.enabled", "hyperspace.index.hybridscan.enabled",
                "hyperspace.index.hybridscan.maxDeletedRatio"):
        session.conf.unset(key)

    # MR7: a served burst
    rng = np.random.default_rng(seed + 60)
    ok_ = L["l_orderkey"]
    keys = rng.choice(np.unique(ok_), 64, replace=False)
    qs = [li.filter(col("l_orderkey") == int(x)).select(*LI_RESIDENT) for x in keys]
    held["b1_preds"] = [col("l_orderkey") == int(x) for x in keys]
    serial = [q.collect() for q in qs]
    session.conf.set("hyperspace.serve.tenant.defaultMaxQueue", 256)
    box = {}

    def burst():
        server = QueryServer(session, ServeConfig(max_workers=4, max_queue=256, batch_max=64,
                                                  autostart=False))
        tickets = [server.submit(q) for q in qs]
        server.start()
        res = [t_.result(timeout=600) for t_ in tickets]
        box["stats"] = server.stats()
        server.close()
        return res

    got, rec = step("MR7 B1 burst", fenced(burst))
    stats = box["stats"]
    for i, (x, r, s_r) in enumerate(zip(keys, got, serial)):
        want = [L[c][ok_ == x] for c in LI_RESIDENT]
        _check(f"mesh MR7 [{i}]", r, LI_RESIDENT, want)
        _check(f"mesh MR7 [{i}] collect", s_r, LI_RESIDENT, want)
    c = rec["counters"]
    if (rec["launches"] != per_shard(tk.K1B) or c.get("serve.batch.dispatches") != 1
            or c.get("serve.batch.queries") != len(qs) or stats["batch_size_hist"] != {64: 1}):
        raise AssertionError(f"mesh MR7: {rec}, hist {stats['batch_size_hist']}")
    rec.update(qps=len(qs) / rec["s"], latency_p50_ms=stats.get("latency_p50_ms"),
               latency_p99_ms=stats.get("latency_p99_ms"))
    session.conf.unset("hyperspace.serve.tenant.defaultMaxQueue")
    log(f"mesh MR7 B1 burst: 64 point lookups {rec['s']:.4f} s ({rec['qps']:.1f} queries/s) "
        f"one dispatch, launches {rec['launches']} (K1b once a shard, N = 64) p50 "
        f"{rec['latency_p50_ms']} ms p99 {rec['latency_p99_ms']} ms | every ticket matches "
        f"numpy and collect()")

    # MR8: a shard's launch lost
    real = tk.resident_counts_tensor
    lost = []

    def lossy(*a, **kw):
        if not lost:
            lost.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was encountered "
                               "(injected by chip_smoke MR8)")
        return real(*a, **kw)

    tk.resident_counts_tensor = lossy
    try:
        got, rec = step("MR8 range device lost", rng_q.collect)
    finally:
        tk.resident_counts_tensor = real
    _check("mesh MR8 range filter", got, R_COLS, rng_want)
    c = rec["counters"]
    if (c.get("scan.resident_mesh.device_failed") != 1 or any(t is table for t in
                                                                mesh_cache._tables)
            or rec["launches"] != per_shard(tk.K1) or not c.get("dist.h2d_bytes")
            or c.get("scan.path.distributed") != 1):
        raise AssertionError(f"mesh MR8: {rec}")
    log(f"mesh MR8 range filter with shard 0's K1c lost: {rec['s']:.4f} s "
        f"scan.resident_mesh.device_failed=1, the table dropped, the per-query route: "
        f"launches {rec['launches']} dist.h2d_bytes={c.get('dist.h2d_bytes')} | rows equal M2's")
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    out["held"] = held
    return out


@contextmanager
def plain_kernels():
    """The kernels' wrappers replaced by their plain torch versions on
    the same tensors (on the card too): a mesh program run inside computes
    its plain version. Nothing inside counts a launch."""
    from hyperspace_tpu_torch.ops import kernels as tk

    names = ("resident_counts_tensor", "hybrid_counts_tensor", "predicate_mask_tensor",
             "sorted_intersect_tensors", "sorted_intersect_packed_tensors")
    saved = {n: getattr(tk, n) for n in names}

    def counts(prepared, names_, cols, specs, n_rows):
        if len(prepared) > 1:
            return tk.predicate_block_counts_batch_reference(prepared, names_, cols, specs,
                                                             n_rows)
        b, pn = prepared[0]
        return tk.predicate_block_counts_packed_reference(b, pn, cols, specs, n_rows)[None]

    def hybrid(prepared, names_, base, delta, words=None):
        if len(prepared) > 1:
            return tk.hybrid_block_counts_batch_reference(prepared, names_, base, delta, words)
        b, pn = prepared[0]
        return tk.hybrid_block_counts_reference(b, pn, base, delta, words)[None]

    def k2(s_tile, span, base, l_, r, fences=None, *, max_span=None):
        return tk.sorted_intersect_span_reference(s_tile, span, base, l_, r)

    def k2p(s_tile, span, base, l_, words, refs, fences, spec, lo_all, *, groups):
        return tk.sorted_intersect_packed_reference(s_tile, span, base, l_, words, refs, spec,
                                                    lo_all, int(fences.shape[0]) * tk.K2_FENCE)

    tk.resident_counts_tensor, tk.hybrid_counts_tensor = counts, hybrid
    tk.predicate_mask_tensor = tk.predicate_mask_reference
    tk.sorted_intersect_tensors, tk.sorted_intersect_packed_tensors = k2, k2p
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(tk, n, f)


def _held_exactly(name: str, got, want) -> float:
    """A mesh program's result against its plain version: count matrices
    and integer columns exactly; float64 group sums, which ``index_add_``
    adds in an order the card picks, to 1e-12 relative. Returns the
    largest absolute difference."""
    if isinstance(got, tuple):
        return max(_held_exactly(name, g, w) for g, w in zip(got, want))
    if isinstance(got, list):
        return max([_held_exactly(name, g, w) for g, w in zip(got, want)] or [0.0])
    if isinstance(got, np.ndarray):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"mesh program {name}: differs from its plain version")
        return 0.0
    err = 0.0
    if got.column_names != want.column_names or got.num_rows != want.num_rows:
        raise AssertionError(f"mesh program {name}: shape differs from its plain version")
    for n in got.column_names:
        g, w = np.asarray(got.columns[n].data), np.asarray(want.columns[n].data)
        if g.dtype.kind == "f":
            if not np.allclose(g, w, rtol=1e-12, atol=0.0, equal_nan=True):
                raise AssertionError(f"mesh program {name}: {n} differs from its plain version")
            err = max(err, float(np.nanmax(np.abs(g - w))) if len(g) else 0.0)
        elif not np.array_equal(g, w):
            raise AssertionError(f"mesh program {name}: {n} differs from its plain version")
    return err


def mesh_resident_programs(mesh, held: dict, L: dict, bounds, repeats: int = 3) -> dict:
    """Each resident mesh program of the port, alone, at the MR steps' shapes
    over the tables, delta and region MR1-MR6 left resident: seconds
    (median of ``repeats`` host-clock calls, each ending in a fence of
    every shard's device), launches (the last call), its plain version's
    seconds and result on the card (``plain_kernels``: the kernels' plain
    versions per shard, the same torch epilogue), held exactly, and the
    bound: a resident program's operand bytes (each read once, the
    outputs written once) over the card's memory rate, a program that
    uploads its windows' bytes over PCIe (``PCIE_BYTES_PER_S``)."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.exec.hbm_cache import prepare_resident_predicate
    from hyperspace_tpu_torch.exec.join_residency import region_agg_plan
    from hyperspace_tpu_torch.exec.mesh_cache import mesh_cache
    from hyperspace_tpu_torch.exec.scan_agg import plan_plane_names, scan_agg_plan
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.residency import streaming as tstream

    import torch

    D = mesh.size
    table, st, region = held["table"], held["streaming"], held["region"]
    hy_table, delta, hy_pred = held["hybrid"]
    lo_k, hi_k, d_lo = bounds
    rng_pred = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k) & (col("l_quantity") < 24)
                & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    top = int(L["l_orderkey"].max())
    st_preds = [(col("l_orderkey") >= lo) & (col("l_orderkey") < lo + top // 10)
                & (col("l_quantity") < 24)
                for lo in np.linspace(1, top - top // 10, 16).astype(int).tolist()]
    q1_aggs = [hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"),
               hs.agg_min("l_shipdate"), hs.agg_max("l_shipdate"), hs.agg_count()]
    j1_aggs = [hs.agg_sum("o_totalprice", "rev"), hs.agg_avg("o_totalprice", "avg_rev"),
               hs.agg_count()]

    def plane_bytes(t, names) -> int:
        total = 0
        for n in names:
            base = n.split("\x00", 1)[0]
            spec = None if "\x00" in n else t.columns[base].pack
            total += D * 4 * (spec.n_words if spec is not None else t.cap)
        return total

    def names_of(t, preds):
        return tuple(dict.fromkeys(n for p in preds
                                   for n in prepare_resident_predicate(t.columns, p)[1]))

    def window_bytes(t, names) -> int:
        lanes = tstream._lanes(t, names)
        return t.n_windows * sum(4 * p.slots[0].numel() for lane in lanes for p in lane.planes)

    def upload_all(t, names):
        lanes = tstream._lanes(t, names)
        for w in range(t.n_windows):
            for lane in lanes:
                with torch.cuda.device(lane.dev), torch.cuda.stream(lane.copy):
                    for p in lane.planes:
                        p.slots[w % 2].copy_(tstream._window_slice(p, w, t.window_rows),
                                             non_blocking=True)
        for lane in lanes:
            lane.copy.synchronize()
        return [p.slots[(t.n_windows - 1) % 2].cpu().numpy() for lane in lanes
                for p in lane.planes]

    def upload_plain(t, names):
        """Every window's slices copied to their shard's device in turn,
        synchronously; the last window's copies home."""
        lanes = tstream._lanes(t, names)
        for w in range(t.n_windows):
            got = [tstream._window_slice(p, w, t.window_rows).to(lane.dev) for lane in lanes
                   for p in lane.planes]
        return [g.cpu().numpy() for g in got]

    rng_names = names_of(table, [rng_pred])
    b1_names = names_of(table, held["b1_preds"])
    hy_names = names_of(hy_table, [hy_pred])
    st_names = names_of(st, [rng_pred])
    st_batch_names = names_of(st, st_preds)
    q1_plan, _r = scan_agg_plan(table, ["l_quantity"], q1_aggs)
    j1_plan = region_agg_plan(region, ["l_partkey"], j1_aggs)
    n_q1_out = 1 + sum(len(c.ops) for c in q1_plan.cols)
    n_j1_out = 1 + sum(len(c.ops) for c in j1_plan.cols)
    region_bytes = sum(int(x.nbytes) for r in region.shards if r is not None
                       for x in [r.l_codes, r.r_codes, r.r_refs, r.fences, *(r.plan or ()),
                                 *(r.k2p_groups.arrays() if r.k2p_groups is not None else ()),
                                 r.l_cols["l_partkey"].slots,
                                 *[a for c in j1_plan.cols for a in
                                   (r.l_cols if c.side == "l" else r.r_cols)[c.name].arrays]]
                       if x is not None)
    nb = table.n_blocks
    programs = {
        "mesh_counts": (lambda: mesh_cache.block_counts(table, rng_pred),
                        plane_bytes(table, rng_names) + 4 * D * nb, "bytes"),
        "mesh_batched_counts": (
            lambda: mesh_cache.block_counts_batch(table, held["b1_preds"]),
            plane_bytes(table, b1_names) + 4 * D * nb * len(held["b1_preds"]), "bytes"),
        "mesh_hybrid_counts": (
            lambda: mesh_cache.hybrid_block_counts(hy_table, delta, hy_pred),
            plane_bytes(hy_table, hy_names) + plane_bytes(delta, hy_names)
            + (D * hy_table.cap // 8 if delta.del_mask is not None else 0)
            + 4 * D * (hy_table.n_blocks + delta.n_blocks), "bytes"),
        "mesh_upload_window": (lambda: upload_all(st, st_names), window_bytes(st, st_names),
                               "PCIe bytes"),
        "mesh_stream_counts": (lambda: mesh_cache.block_counts(st, rng_pred),
                               window_bytes(st, st_names), "PCIe bytes"),
        "mesh_stream_counts_batch": (lambda: mesh_cache.block_counts_batch(st, st_preds),
                                     window_bytes(st, st_batch_names), "PCIe bytes"),
        "mesh_join_agg": (lambda: mesh_cache.join_agg(region, ["l_partkey"], j1_aggs),
                          region_bytes + 8 * D * n_j1_out * j1_plan.span, "bytes"),
        "mesh_scan_agg": (
            lambda: mesh_cache.agg_scan(table, window, ["l_quantity"], q1_aggs)[0],
            plane_bytes(table, tuple(dict.fromkeys(names_of(table, [window])
                                                   + plan_plane_names(q1_plan))))
            + 8 * D * n_q1_out * (q1_plan.span + 1), "bytes"),
    }
    if mesh.device_type == "cpu":  # a rehearsal: no copy streams to time
        del programs["mesh_upload_window"]
    out = {}
    for name, (call, nbytes, bound_by) in programs.items():
        def timed(fn):
            t = time.perf_counter()
            res = fn()
            for dev in dict.fromkeys(mesh.devices):
                fence(dev)
            return res, time.perf_counter() - t

        secs = []
        for _ in range(repeats):
            reset_launch_counts()
            got, s = timed(call)
            secs.append(s)
        launches = launch_counts()
        if name == "mesh_upload_window":  # its plain version: synchronous copies
            plain, plain_s = timed(lambda: upload_plain(st, st_names))
        else:
            with plain_kernels():
                plain, plain_s = timed(call)
        err = _held_exactly(name, got, plain)
        rate = PCIE_BYTES_PER_S if bound_by == "PCIe bytes" else H100_BYTES_PER_S
        rec = {"replaces": MESH_RESIDENT_REFS[name], "ms": statistics.median(secs) * 1e3,
               "ms_all": [x * 1e3 for x in secs], "plain_ms": plain_s * 1e3,
               "launches": launches, "max_abs_err": err, "bytes": int(nbytes),
               "bound_ms": nbytes / rate * 1e3, "bound_by": bound_by}
        out[name] = rec
        log(f"mesh program {name} ({rec['replaces']}): {rec['ms']:.3f} ms (median of {repeats}: "
            f"{', '.join(f'{x:.3f}' for x in rec['ms_all'])}) launches {launches} | plain "
            f"{rec['plain_ms']:.3f} ms, held exactly (max_abs_err {err}) | bound "
            f"{rec['bound_ms']:.4f} ms ({nbytes} B, {bound_by})")
    return out


def mesh_phase(lineitem, orders, workdir: Path, device: str, seed: int,
               profile: bool = False, dist_min_rows: int = None,
               single_build_s: dict = None) -> dict:
    """The bucket mesh at SF1, in its own session: ``make_mesh(4,
    device="cuda:0")`` (4 shards on one card: every sharded path, every
    per-shard K1 and K2 launch and the exchange run there; no traffic
    between cards), residency off, over the main path's avro source
    (written here when the workdir lacks it). ``dist_min_rows`` sets conf
    ``hyperspace.tpu.distributedQuery.minRows`` (None: its default,
    1,000,000). Each step counts launches from 0 and holds its rows
    against numpy:

    M1 the sharded build: li_mesh and ord_mesh (200 buckets) and ord_m64
       (orders at 64 buckets), each create through one all_to_all
       exchange; every file of li_mesh and ord_mesh equals the
       single-device build's (the main path's li_idx and ord_idx, or
       copies built here when main did not run) byte for byte, the
       footer's index name aside; then li_mesh_st through the streaming
       build's mesh arm (the threshold lowered under the source so it
       streams), its range filter checked;
    M2 filters: the range filter over li_mesh's 200 files (above the gate)
       launches K1 once a shard; a point lookup reads one bucket, below
       the gate, and launches none (the host masks it);
    M3 the co-partitioned Q3 over li_mesh and ord_mesh: K2 and K2F once a
       shard, join.path.distributed = 1;
    M4 A3's Q1 shape over li_mesh: the two-phase aggregate, K1 once a
       shard, aggregate.path.distributed = 1, groups against numpy;
    M5 the shuffle join: ord_mesh soft-deleted, so Q3 joins li_mesh to
       ord_m64; the planner moves the filtered orders into the 200-bucket
       space in one round (shuffle.rounds = 1, rows_moved = numpy's count),
       then K2 and K2F once a shard; rows equal M3's, in order;
    M6 an exchange lost: M5's query with ``all_to_all`` raising a
       RuntimeError on its first call: shuffle.device_failed = 1, and the
       exact join on the first shard's device (one K2, one K2F; each side's
       filter through the mesh's K1) answers with M3's rows.

    Then MR1-MR8 in the same session with residency forced: the mesh
    cache's tiers, resident filters, aggregates, the join region, the
    hybrid, a served burst and a shard's launch lost
    (``mesh_resident_steps``). Then each mesh program alone at these
    shapes (``mesh_programs``, ``mesh_resident_programs``); its launches
    are not counted on the path."""
    import torch

    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.distributed import shuffle as shuffle_mod
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.ops.kernels import K1, K2, K2F
    from hyperspace_tpu_torch.parallel.mesh import make_mesh
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    on_card = device == "cuda"
    one = int(on_card)
    t_phase = time.perf_counter()
    L, O = lineitem, orders
    n_l, n_o = len(L["l_orderkey"]), len(O["o_orderkey"])
    li_dir, od_dir = workdir / "src" / "lineitem", workdir / "src" / "orders"
    if not (li_dir.is_dir() and od_dir.is_dir()):
        li_dir = Path(write_avro_dir(li_dir, L, LINEITEM_SCHEMA, 8))
        od_dir = Path(write_avro_dir(od_dir, O, ORDERS_SCHEMA, 2))
    mesh = make_mesh(MESH_SHARDS, device="cuda:0" if on_card else "cpu")
    if on_card:
        torch.empty(1, device=mesh.devices[0])  # the allocator's stats exist once it ran
        torch.cuda.reset_peak_memory_stats(mesh.devices[0])
    D = mesh.size
    root = workdir / "indexes_mesh"
    conf = {"hyperspace.system.path": str(root),
            "hyperspace.index.numBuckets": NUM_BUCKETS,
            "hyperspace.index.build.mode": "inmemory",
            "hyperspace.torch.device": device,
            "hyperspace.torch.hbm.mode": "off"}
    if dist_min_rows is not None:
        conf["hyperspace.tpu.distributedQuery.minRows"] = int(dist_min_rows)
    session = hs.HyperspaceSession(hs.HyperspaceConf(dict(conf)), mesh=mesh)
    hsp = hs.Hyperspace(session)
    gate = session.conf.distributed_min_rows()
    out = {"shards": D, "devices": [str(d) for d in mesh.devices], "dist_min_rows": gate,
           "steps": {}}

    def step(name, fn):
        """Run ``fn`` with launches and metrics from 0; record its seconds,
        launches and counters."""
        reset_launch_counts()
        metrics.reset()
        t = time.perf_counter()
        with _Profiled(f"mesh {name}", profile):
            res = fn()
        fence(session.device)
        rec = {"s": time.perf_counter() - t, "launches": launch_counts(),
               "counters": {k: v for k, v in metrics.snapshot().items()
                            if k.startswith(("scan.", "join.path", "aggregate.path", "shuffle.",
                                             "dist.", "build.stream.", "compile.", "hbm.",
                                             "serve.batch", "residency."))}}
        out["steps"][name] = rec
        return res, rec

    # M1: the sharded build
    for name, path, key, incl, nb in (
            ("li_mesh", li_dir, "l_orderkey", MESH_LI_COLS, NUM_BUCKETS),
            ("ord_mesh", od_dir, "o_orderkey", MESH_OD_COLS, NUM_BUCKETS),
            ("ord_m64", od_dir, "o_orderkey", MESH_OD_COLS, 64)):
        session.conf.set("hyperspace.index.numBuckets", nb)
        _, rec = step(f"M1 build {name}", lambda: hsp.create_index(
            session.read.avro(str(path)), hs.IndexConfig(name, [key], incl)))
        rows = n_l if name == "li_mesh" else n_o
        rec["rows_per_s"] = rows / rec["s"]
        single = (single_build_s or {}).get({"li_mesh": "li_idx", "ord_mesh": "ord_idx"}.get(
            name, ""))
        log(f"mesh M1 build {name} ({nb} buckets, {D} shards): {rec['s']:.3f} s "
            f"{rec['rows_per_s']:.0f} rows/s" + (f" | the main path's single-device build: "
                                                 f"{single:.3f} s {rows / single:.0f} rows/s"
                                                 if single else ""))
    session.conf.set("hyperspace.index.numBuckets", NUM_BUCKETS)
    single_root = workdir / "indexes"
    if not (single_root / "li_idx").is_dir():
        # main did not run: the single-device builds the bytes are held
        # against, made here
        single_root = workdir / "indexes_mesh_single"
        s1 = hs.HyperspaceSession(hs.HyperspaceConf({**conf, "hyperspace.system.path":
                                                     str(single_root)}))
        h1 = hs.Hyperspace(s1)
        h1.create_index(s1.read.avro(str(li_dir)), hs.IndexConfig(
            "li_idx", ["l_orderkey"], MESH_LI_COLS))
        h1.create_index(s1.read.avro(str(od_dir)), hs.IndexConfig(
            "ord_idx", ["o_orderkey"], MESH_OD_COLS))
    compared = {n: _same_index_bytes(root / n, single_root / s, n)
                for n, s in (("li_mesh", "li_idx"), ("ord_mesh", "ord_idx"))}
    out["bytes_equal_files"] = compared
    log(f"mesh M1: li_mesh's {compared['li_mesh']} and ord_mesh's {compared['ord_mesh']} files "
        f"equal the single-device build's ({single_root.name}) byte for byte")
    bounds = range_bounds(L)
    rng_want, q3_want = range_and_q3_truth(L, O, bounds, "mesh")
    # li_mesh_st: the streaming build's mesh arm, in a session of its own
    src_bytes = sum(f.stat().st_size for f in li_dir.glob("*.avro"))
    st_conf = {**conf, "hyperspace.system.path": str(workdir / "indexes_mesh_st"),
               "hyperspace.index.build.mode": "auto",
               "hyperspace.index.build.streamingThresholdBytes": src_bytes // 2}
    st_session = hs.HyperspaceSession(hs.HyperspaceConf(st_conf), mesh=mesh)
    _, rec = step("M1 build li_mesh_st", lambda: hs.Hyperspace(st_session).create_index(
        st_session.read.avro(str(li_dir)), hs.IndexConfig("li_mesh_st", ["l_orderkey"],
                                                           MESH_LI_COLS)))
    if rec["counters"].get("build.stream.rows") != n_l:
        raise AssertionError(f"mesh M1: li_mesh_st did not stream: {rec['counters']}")
    st_session.enable_hyperspace()
    st_range, _ = range_and_q3(st_session, li_dir, od_dir, bounds)
    got, rec_st = step("M1 li_mesh_st range", st_range.collect)
    _check("mesh M1 li_mesh_st range filter", got, R_COLS, rng_want)
    log(f"mesh M1 build li_mesh_st (streamed, {rec['counters'].get('build.stream.chunks')} "
        f"chunks through the sharded build): {rec['s']:.3f} s {n_l / rec['s']:.0f} rows/s | its "
        f"range filter {rec_st['s']:.4f} s rows={got.num_rows} launches {rec_st['launches']} "
        f"matches numpy")

    session.enable_hyperspace()
    rng_q, q3 = range_and_q3(session, li_dir, od_dir, bounds)
    if "li_mesh" not in plan_with_indexes(rng_q) or "ord_mesh" not in plan_with_indexes(q3):
        raise AssertionError("mesh: the queries are not served by li_mesh and ord_mesh")
    # M2: filters
    got, rec = step("M2 range", rng_q.collect)
    _check("mesh M2 range filter", got, R_COLS, rng_want)
    c = rec["counters"]
    if (c.get("scan.path.distributed") != 1 or c.get("scan.files_read") != NUM_BUCKETS
            or rec["launches"].get(K1, 0) != one * D):
        raise AssertionError(f"mesh M2 range filter: {rec}")
    k = int(L["l_orderkey"][n_l // 2])
    point = session.read.avro(str(li_dir)).filter(col("l_orderkey") == k).select(*R_COLS)
    got_p, rec_p = step("M2 point", point.collect)
    _check("mesh M2 point lookup", got_p, R_COLS, [L[c_][L["l_orderkey"] == k] for c_ in R_COLS])
    if (rec_p["counters"].get("scan.files_read") != 1 or rec_p["launches"].get(K1, 0)
            or rec_p["counters"].get("scan.path.distributed")):
        raise AssertionError(f"mesh M2 point lookup: {rec_p}")
    log(f"mesh M2 range filter: {rec['s']:.4f} s rows={got.num_rows} files=200 launches "
        f"{rec['launches']} (one K1 a shard) dist.h2d_bytes={c.get('dist.h2d_bytes')} | point "
        f"lookup: {rec_p['s']:.4f} s rows={got_p.num_rows}, one bucket under the gate "
        f"({gate} rows): the host masks it, launches {rec_p['launches']} | match numpy")
    # M3: the co-partitioned Q3
    m3, rec = step("M3 q3", q3.collect)
    _check("mesh M3 q3", m3, Q3_COLS, q3_want)
    c = rec["counters"]
    if (c.get("join.path.distributed") != 1 or rec["launches"].get(K2, 0) != one * D
            or rec["launches"].get(K2F, 0) != one * D):
        raise AssertionError(f"mesh M3 q3: {rec}")
    log(f"mesh M3 q3 (li_mesh x ord_mesh, co-partitioned): {rec['s']:.4f} s rows={m3.num_rows} "
        f"launches {rec['launches']} (K2 and K2F once a shard) join.path.distributed=1 "
        f"matches numpy")
    # M4: the two-phase aggregate
    lo_k, hi_k, d_lo = bounds
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    w_mask = ((L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k)
              & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))
    q1 = session.read.avro(str(li_dir)).filter(window).group_by("l_quantity").agg(
        hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"), hs.agg_min("l_shipdate"),
        hs.agg_max("l_shipdate"), hs.agg_count())
    got, rec = step("M4 q1_shape", q1.collect)
    m4 = got
    _check_agg("mesh M4 q1_shape", got, ["l_quantity"], q1_shape_truth(L, w_mask))
    if (rec["counters"].get("aggregate.path.distributed") != 1
            or rec["launches"].get(K1, 0) != one * D):
        raise AssertionError(f"mesh M4 q1_shape: {rec}")
    log(f"mesh M4 q1_shape (two-phase aggregate): {rec['s']:.4f} s groups={got.num_rows} "
        f"launches {rec['launches']} (one K1 a shard) aggregate.path.distributed=1 matches numpy")
    # M5: the shuffle join into the 200-bucket space
    hsp.delete_index("ord_mesh")
    _, q3_64 = range_and_q3(session, li_dir, od_dir, bounds)
    if "ord_m64" not in plan_with_indexes(q3_64):
        raise AssertionError("mesh M5: Q3 is not served by ord_m64")
    moved_want = int((O["o_orderdate"] < DAY_1995_03_15).sum())
    m5, rec = step("M5 q3 shuffle", q3_64.collect)
    c = rec["counters"]
    if (c.get("shuffle.plan.shuffle") != 1 or c.get("shuffle.rounds") != 1
            or c.get("shuffle.rows_moved") != moved_want
            or c.get("scan.path.resident_join_shuffle") != 1
            or c.get("join.path.distributed") != 1
            or rec["launches"].get(K2, 0) != one * D or rec["launches"].get(K2F, 0) != one * D):
        raise AssertionError(f"mesh M5 q3 shuffle: {rec}")
    if m5.column_names != m3.column_names or not all(
            np.array_equal(m5.columns[n].data, m3.columns[n].data) for n in Q3_COLS):
        raise AssertionError("mesh M5: the shuffle join's rows differ from M3's")
    log(f"mesh M5 q3 (li_mesh x ord_m64, shuffled): {rec['s']:.4f} s rows={m5.num_rows} "
        f"rounds={c.get('shuffle.rounds')} rows_moved={c.get('shuffle.rows_moved')} (numpy "
        f"{moved_want}) ici_bytes={c.get('shuffle.ici_bytes')} h2d_bytes="
        f"{c.get('shuffle.h2d_bytes')} launches {rec['launches']} | rows equal M3's, in order")
    # M6: the exchange lost on its first call
    real = shuffle_mod.all_to_all
    lost = []

    def lossy(blocks, mesh_):
        if not lost:
            lost.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was encountered "
                               "(injected by chip_smoke M6)")
        return real(blocks, mesh_)

    shuffle_mod.all_to_all = lossy
    try:
        m6, rec = step("M6 q3 exchange lost", q3_64.collect)
    finally:
        shuffle_mod.all_to_all = real
    c = rec["counters"]
    if (c.get("shuffle.device_failed") != 1 or c.get("shuffle.declined.device_failed") != 1
            or rec["launches"].get(K2, 0) != one or rec["launches"].get(K2F, 0) != one):
        raise AssertionError(f"mesh M6 exchange lost: {rec}")
    _check("mesh M6 q3", m6, Q3_COLS, [np.asarray(m3.columns[n].data) for n in Q3_COLS])
    hsp.restore_index("ord_mesh")
    log(f"mesh M6 q3 with the exchange lost: {rec['s']:.4f} s rows={m6.num_rows} "
        f"shuffle.device_failed={c.get('shuffle.device_failed')}, the exact join on "
        f"{mesh.devices[0]}: launches {rec['launches']} | rows equal M3's")
    t = time.perf_counter()
    mr = mesh_resident_steps(session, hsp, mesh, L, O, workdir, root, li_dir, od_dir, bounds,
                             step, m4, seed, on_card)
    out["resident_steps_s"] = time.perf_counter() - t
    out["launches"] = {kname: sum(r["launches"].get(kname, 0) for r in out["steps"].values())
                       for kname in (tk.K1, tk.K1C, tk.K1P, tk.K1H, tk.K1B, tk.K2, tk.K2F,
                                     tk.K2P)}
    t = time.perf_counter()
    out["programs"] = mesh_programs(mesh, L, root, bounds)
    out["resident_programs"] = mesh_resident_programs(mesh, mr["held"], L, bounds)
    out["programs_s"] = time.perf_counter() - t
    out["peak_mem_bytes"] = (max(mr["peak_before_mr"], torch.cuda.max_memory_allocated(
        mesh.devices[0])) if on_card else None)
    out["phase_s"] = time.perf_counter() - t_phase
    log("mesh: " + json.dumps({**out, "note": f"{D} shards on one {device} device: no "
                                               "inter-card traffic"}))
    return out


# ---------------------------------------------------------------------------
# fabric phase: the multi-controller tier (process group, router, chaos)
# ---------------------------------------------------------------------------
# TPC-H's seven ship modes (sorted: a string column's vocab is ordered)
FABRIC_SHIPMODES = np.array([b"AIR", b"FOB", b"MAIL", b"RAIL", b"REG AIR", b"SHIP", b"TRUCK"],
                            dtype=object)
FABRIC_PROCS = 2  # worker processes of F1
FABRIC_LOCAL = 2  # shards a worker drives (all on the phase's card)
FABRIC_CHAOS_QUERIES = 16  # F5's crash run
FABRIC_FLAP_QUERIES = 10  # F5's flap run, 0.06 s of its clock a query
FABRIC_COUNTER_PREFIXES = ("router.", "serve.chaos.", "serve.batch.", "compile.agg.",
                           "compile.warm_hint.", "scan.path.", "mesh.")


def _fabric_batch(cols: dict, shipmode_codes: np.ndarray):
    """lineitem's columns plus l_shipmode (codes into ``FABRIC_SHIPMODES``)
    as a batch of the port."""
    from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch

    out = {name: Column(LINEITEM_SCHEMA[name], np.ascontiguousarray(cols[name]))
           for name in LINEITEM_SCHEMA}
    out["l_shipmode"] = Column("string", np.ascontiguousarray(shipmode_codes, dtype=np.int32),
                               FABRIC_SHIPMODES)
    return ColumnarBatch(out)


def fabric_worker(pid: str, nproc: str, fdir: str, device: str) -> int:
    """One process of F1 (``chip_smoke.py --fabric-worker PID NPROC DIR
    DEVICE``): joins the gloo group through ``DIR/pg_init``, builds its half
    (``DIR/half-PID.npz``) on ``FABRIC_LOCAL`` shards of ``DEVICE`` through
    ``QueryFabric.build_sharded``, writes only its own buckets' files under
    ``DIR/index`` and its record to ``DIR/worker-PID.json``."""
    import torch
    import torch.distributed

    from hyperspace_tpu_torch.distributed import QueryFabric
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.parallel.mesh import make_mesh
    from hyperspace_tpu_torch.storage import layout

    pid, nproc, fdir = int(pid), int(nproc), Path(fdir)
    t0 = time.perf_counter()
    with np.load(fdir / f"half-{pid}.npz", allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    local = _fabric_batch(data, data["l_shipmode"])
    local_mesh = make_mesh(FABRIC_LOCAL, device=device)
    dev = local_mesh.devices[0]
    fabric = QueryFabric(init_method=f"file://{fdir / 'pg_init'}", num_processes=nproc,
                         process_id=pid, local_mesh=local_mesh, backend="gloo").connect()
    t_connect = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the allocator's stats exist once it ran
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    per_local, counts = fabric.build_sharded(local, ["l_orderkey"], NUM_BUCKETS,
                                             scratch_dir=fdir / "vocab")
    fence(dev)
    build_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    mine = set(fabric.local_buckets(NUM_BUCKETS))
    out_dir = fdir / "index"
    out_dir.mkdir(exist_ok=True)
    written, t = [], time.perf_counter()
    for batch, bucket_ids in per_local:
        bounds = np.flatnonzero(np.diff(bucket_ids)) + 1
        for s, e in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [len(bucket_ids)]])):
            if e <= s:
                continue
            b = int(bucket_ids[s])
            if b not in mine:
                raise AssertionError(f"fabric worker {pid}: bucket {b} is another process's")
            layout.write_batch(out_dir / layout.bucket_file_name(b), batch.take(np.arange(s, e)),
                               sorted_by=["l_orderkey"], bucket=b)
            written.append(b)
    rec = {"pid": pid, "rows": local.num_rows, "connect_s": t_connect, "build_s": build_s,
           "write_s": time.perf_counter() - t, "staged_bytes": fabric.mesh.staged_bytes,
           "staging_alloc_s": fabric.mesh.staging_alloc_s,
           "peak_mem_bytes": peak, "buckets": sorted(written),
           "global_counts": [int(c) for c in counts], "info": fabric.info()}
    (fdir / f"worker-{pid}.json").write_text(json.dumps(rec))
    print(f"fabric worker {pid}: {local.num_rows} rows built in {build_s:.3f} s, "
          f"{len(written)} bucket files", flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _rows_sorted(cols: list) -> list:
    """Columns reordered by all of them (a multiset's canonical order);
    floats compare by their bits."""
    keys = [c.view(np.int64) if c.dtype == np.float64 else c for c in cols]
    order = np.lexsort(tuple(reversed(keys)))
    return [k[order] for k in keys]


def fabric_build(L: dict, fdir: Path, device: str, seed: int) -> dict:
    """F1: two worker processes, each one contiguous half of lineitem (with
    l_shipmode), one gloo group, ``FABRIC_LOCAL`` shards each on the card;
    held against the parent's ``build_partition_sharded`` over the whole
    table on a mesh of the same D shards."""
    import subprocess as sp

    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.ops.build import build_partition_sharded, encode_for_device
    from hyperspace_tpu_torch.parallel.mesh import make_mesh
    from hyperspace_tpu_torch.storage import layout

    n = len(L["l_orderkey"])
    D = FABRIC_PROCS * FABRIC_LOCAL
    modes = np.random.default_rng(seed + 70).integers(0, len(FABRIC_SHIPMODES), n).astype(np.int32)
    cuts = np.linspace(0, n, FABRIC_PROCS + 1).astype(np.int64)
    fdir.mkdir(parents=True)
    t = time.perf_counter()
    for pid in range(FABRIC_PROCS):
        lo, hi = int(cuts[pid]), int(cuts[pid + 1])
        np.savez(fdir / f"half-{pid}.npz", l_shipmode=modes[lo:hi],
                 **{c: L[c][lo:hi] for c in LINEITEM_SCHEMA})
    out = {"rows": n, "shards": D, "handoff": "npz files the parent writes",
           "handoff_s": time.perf_counter() - t,
           "handoff_bytes": sum((fdir / f"half-{p}.npz").stat().st_size
                                for p in range(FABRIC_PROCS))}
    t = time.perf_counter()
    procs = [sp.Popen([sys.executable, str(Path(__file__).resolve()), "--fabric-worker", str(pid),
                       str(FABRIC_PROCS), str(fdir), "cuda:0" if device == "cuda" else device],
                      stdout=sp.PIPE, stderr=sp.STDOUT) for pid in range(FABRIC_PROCS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["workers_wall_s"] = time.perf_counter() - t
    for pid, (p, text) in enumerate(zip(procs, logs)):
        for line in text.strip().splitlines()[-3:]:
            log(f"fabric F1 worker {pid}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"fabric F1: worker {pid} exited {p.returncode}:\n{text[-4000:]}")
    workers = [json.loads((fdir / f"worker-{pid}.json").read_text())
               for pid in range(FABRIC_PROCS)]
    out["workers"] = [{k: w[k] for k in ("rows", "connect_s", "build_s", "write_s",
                                         "staged_bytes", "staging_alloc_s", "peak_mem_bytes")}
                      for w in workers]
    # the same rows whole, through the single-controller build on D shards
    whole = _fabric_batch(L, modes)
    t = time.perf_counter()
    mesh = make_mesh(D, device="cuda:0" if device == "cuda" else device)
    per_shard, counts = build_partition_sharded(whole, ["l_orderkey"], NUM_BUCKETS, mesh)
    fence(mesh.devices[0])
    out["single_controller_s"] = time.perf_counter() - t
    for w in workers:
        owned = {b for b in range(NUM_BUCKETS) if (b % D) // FABRIC_LOCAL == w["pid"]}
        if w["global_counts"] != counts.tolist() or not set(w["buckets"]) <= owned:
            raise AssertionError(f"fabric F1: worker {w['pid']}'s counts or buckets differ")
    t = time.perf_counter()
    names = list(LINEITEM_SCHEMA) + ["l_shipmode"]
    files = {layout.bucket_of_file(f): f for f in (fdir / "index").glob("*.tcb")}
    if sorted(files) != sorted(np.flatnonzero(counts).tolist()):
        raise AssertionError(f"fabric F1: {len(files)} bucket files, "
                             f"{int(np.count_nonzero(counts))} non-empty buckets")
    for b, f in sorted(files.items()):
        got = layout.read_batch(f)
        keys = got.columns["l_orderkey"].data
        if np.any(keys[1:] < keys[:-1]) or list(got.columns["l_shipmode"].vocab) != \
                list(FABRIC_SHIPMODES):
            raise AssertionError(f"fabric F1: bucket {b}'s file is out of key order or vocab")
        batch, ids = per_shard[b % D]
        rows = np.flatnonzero(ids == b)
        want = _rows_sorted([np.asarray(batch.columns[c].data)[rows] for c in names])
        have = _rows_sorted([np.asarray(got.columns[c].data) for c in names])
        if not all(np.array_equal(x, y) for x, y in zip(have, want)):
            raise AssertionError(f"fabric F1: bucket {b}'s rows differ from the "
                                 "single-controller build's")
    out["check_s"] = time.perf_counter() - t
    out["build_s"] = max(w["build_s"] for w in workers)
    # the bound: every row's exchange record (its planes in transport
    # encoding, the bucket id, the validity byte) crosses PCIe once down and
    # once up under gloo's host staging, on separate 64 GB/s directions; the
    # staged bytes beside it also hold the blocks' padding up to cap
    out["row_bytes"] = sum(encode_for_device(c).dtype.itemsize
                           for c in whole.columns.values()) + 4 + 1
    out["row_exchange_bytes"] = 2 * n * out["row_bytes"]
    staged = sum(w["staged_bytes"] for w in workers)
    out["staged_bytes"] = staged
    out["padding_factor"] = staged / out["row_exchange_bytes"]
    out["bound_ms"] = n * out["row_bytes"] / PCIE_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    log(f"fabric F1 multi-process build: {FABRIC_PROCS} processes x {FABRIC_LOCAL} shards on "
        f"{device}, {n} rows ({out['handoff_bytes']} bytes handed over in "
        f"{out['handoff_s']:.3f} s) | build s per worker "
        f"{[round(w['build_s'], 4) for w in workers]}, staged bytes "
        f"{[w['staged_bytes'] for w in workers]} ({out['padding_factor']:.3f}x the rows' "
        f"{out['row_exchange_bytes']} B, {out['row_bytes']} B a row down and up), pinning s "
        f"{[round(w['staging_alloc_s'], 4) for w in workers]}, peak device "
        f"memory {[w['peak_mem_bytes'] for w in workers]} | bound {out['bound_ms']:.3f} ms "
        f"(the rows' bytes over PCIe) | "
        f"workers' wall {out['workers_wall_s']:.3f} s | single-controller build "
        f"{out['single_controller_s']:.3f} s | {len(files)} files checked in "
        f"{out['check_s']:.3f} s: counts, rows and key order equal the single-controller "
        f"build's")
    return out


def _same_groups(name: str, got, want) -> None:
    """Two aggregates' groups: integer columns exact, floats rtol 1e-9."""
    if got.column_names != want.column_names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.column_names} x {got.num_rows} against "
                             f"{want.column_names} x {want.num_rows}")
    for c in got.column_names:
        g, w = np.asarray(got.columns[c].data), np.asarray(want.columns[c].data)
        ok = (np.allclose(g, w, rtol=1e-9, atol=0.0, equal_nan=True) if w.dtype.kind == "f"
              else np.array_equal(g, w))
        if not ok:
            raise AssertionError(f"{name}: column {c} differs")


class _Clock:
    """A clock the phase sets (the chaos schedule's and health director's)."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def fabric_phase(lineitem, orders, workdir: Path, device: str, seed: int,
                 profile: bool = False) -> dict:
    """The multi-controller tier over the main path's li_idx (shared
    storage) and lineitem:

    F1 the multi-process build (``fabric_build``): 2 worker processes
       (``--fabric-worker``), each half of lineitem with l_shipmode, one
       gloo group through a ``file://`` store, 2 shards each on the card.
    F2-F6 two "hosts" over the main path's index root, each a session with
       residency forced and a QueryServer on the card, built through
       ``QueryFabric.make_router``; host i takes half i of l_orderkey:
    F2 A3's Q1 shape: merged groups equal the single session's (ints
       exact, floats rtol 1e-9) and numpy's; one K1 a host leg (the
       device aggregate), ``router.merge.agg``;
    F3 the range filter, merged by concatenation: rows equal numpy's; one
       K1c a host leg, ``router.merge.concat``;
    F4 64 identical point lookups on paused servers coalesce onto one
       fan-out (``router.coalesced`` = 63); then B1's 64 distinct lookups
       launch K1b once a host (N = 64); rows equal numpy's and the single
       queries';
    F5 chaos (``FaultPlan``): host b crashes at its 3rd submission and 16
       A3 queries complete with 0 failed tickets, ``router.host_lost`` = 1;
       a slow host b (its legs withheld on a frozen clock) is hedged and the
       hedge wins; a flapping host b (outages of 0.2 s on the phase's
       clock, 0.06 s a query) is readmitted through a probation probe, then
       ``revive_host`` swaps in a fresh server and the next query readmits
       it;
    F6 the fleet result cache: a repeated F2 query hits
       ``router.result_cache`` with zero fan-out legs; ``offer_warm_hints``
       to a cold host adopts at least one shape.

    Each step counts launches from 0 and prints its seconds, launches and
    counters."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.compile.cache import pipeline_cache
    from hyperspace_tpu_torch.distributed import QueryFabric, QueryRouter
    from hyperspace_tpu_torch.distributed.health import HealthDirector, HealthPolicy
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.parallel.mesh import make_mesh
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.reliability.chaos import ChaosHostProxy, FaultPlan, HostFault
    from hyperspace_tpu_torch.reliability.retry import RetryPolicy
    from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    on_card = device == "cuda"
    one = int(on_card)
    t_phase = time.perf_counter()
    L = lineitem
    li_dir = workdir / "src" / "lineitem"
    out = {"steps": {}}
    out["F1"] = fabric_build(L, workdir / "fabric", device, seed)

    def host_session(**conf):
        values = {"hyperspace.system.path": str(workdir / "indexes"),
                  "hyperspace.index.numBuckets": NUM_BUCKETS,
                  "hyperspace.torch.device": device, "hyperspace.torch.hbm.mode": "force",
                  "hyperspace.serve.tenant.defaultMaxQueue": 256, **conf}
        if not on_card:  # a rehearsal: the zone gate would route small tables away
            values["hyperspace.torch.hbm.maxBlockFrac"] = 1.0
        return hs.HyperspaceSession(hs.HyperspaceConf(values)).enable_hyperspace()

    def read(s):
        return s.read.avro(str(li_dir))

    serve_conf = ServeConfig(max_workers=4, max_queue=256, batch_max=64, autostart=False)
    fabric = QueryFabric(local_mesh=make_mesh(1, device="cuda:0" if on_card else "cpu")).connect()
    sa, sb = host_session(), host_session()
    t = time.perf_counter()
    if not hs.Hyperspace(sa).prefetch_index("li_idx", SERVE_COLS):
        raise AssertionError("fabric: prefetch_index(li_idx) did not make the index resident")
    hbm_cache.wait_background()
    fence(sa.device)
    out["prefetch_s"] = time.perf_counter() - t

    ok = L["l_orderkey"]
    lo_k, hi_k, d_lo = range_bounds(L)
    mid = (lo_k + hi_k) // 2

    def half(i, pred):
        return pred & ((col("l_orderkey") < mid) if i == 0 else (col("l_orderkey") >= mid))

    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    w_mask = ((ok >= lo_k) & (ok < hi_k) & (L["l_shipdate"] >= d_lo)
              & (L["l_shipdate"] < DAY_1995_03_15))
    a3_want = q1_shape_truth(L, w_mask)

    def a3(df):
        return df.group_by("l_quantity").agg(
            hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"),
            hs.agg_min("l_shipdate"), hs.agg_max("l_shipdate"), hs.agg_count())

    def a3_build(s, i, n):
        return a3(read(s).filter(half(i, window)))

    rng_pred = window & (col("l_quantity") < 24)
    rng_mask = w_mask & (L["l_quantity"] < 24)

    def step(name, fn):
        reset_launch_counts()
        metrics.reset()
        t = time.perf_counter()
        with _Profiled(f"fabric {name}", profile):
            res = fn()
        fence(sa.device)
        rec = {"s": time.perf_counter() - t, "launches": launch_counts(),
               "counters": {k: v for k, v in metrics.snapshot().items()
                            if k.startswith(FABRIC_COUNTER_PREFIXES)}}
        out["steps"][name] = rec
        log(f"fabric {name}: {rec['s']:.4f} s launches {rec['launches']} counters "
            f"{rec['counters']}")
        return res, rec

    def routed(router, build, n=1):
        tickets = [router.submit(build) for _ in range(n)]
        return [t_.result(timeout=600) for t_ in tickets]

    # F2: the aggregate through the router
    a3_single = a3(read(sa).filter(window)).collect()
    router = fabric.make_router({"a": sa, "b": sb}, serve_config=serve_conf).start()
    try:
        (f2,), rec = step("F2 router aggregate", lambda: routed(router, a3_build))
    finally:
        router.close()
    _same_groups("fabric F2", f2, a3_single)
    _check_agg("fabric F2", f2, ["l_quantity"], a3_want)
    c = rec["counters"]
    if (rec["launches"].get(tk.K1, 0) != 2 * one or c.get("router.merge.agg") != 1
            or c.get("compile.agg.device") != 2 or c.get("router.subqueries") != 2):
        raise AssertionError(f"fabric F2: {rec}")

    # F3: the range filter, merged by concatenation
    router = fabric.make_router({"a": sa, "b": sb}, serve_config=serve_conf).start()
    try:
        (f3,), rec = step("F3 router range filter", lambda: routed(
            router, lambda s, i, n: read(s).filter(half(i, rng_pred)).select(*LI_RESIDENT)))
    finally:
        router.close()
    _check("fabric F3", f3, LI_RESIDENT, [L[c_][rng_mask] for c_ in LI_RESIDENT])
    c = rec["counters"]
    if (rec["launches"].get(tk.K1C, 0) != 2 * one or c.get("router.merge.concat") != 1
            or sum(rec["launches"].values()) != 2 * one):
        raise AssertionError(f"fabric F3: {rec}")

    # F4: bursts on paused servers
    keys = np.random.default_rng(seed + 30).choice(np.unique(ok), 64, replace=False)

    def lookup(k):
        return lambda s, i, n: read(s).filter(half(i, col("l_orderkey") == int(k))).select(
            *LI_RESIDENT)

    router = fabric.make_router({"a": sa, "b": sb}, serve_config=serve_conf)
    try:
        def identical():
            tickets = [router.submit(lookup(keys[0])) for _ in range(64)]
            router.start()
            return [t_.result(timeout=600) for t_ in tickets]

        same, rec = step("F4 64 identical lookups", identical)
    finally:
        router.close()
    if rec["counters"].get("router.coalesced") != 63 or rec["counters"].get("router.fanout") != 1:
        raise AssertionError(f"fabric F4 identical: {rec}")
    for r in same:
        _check("fabric F4 identical", r, LI_RESIDENT, [L[c_][ok == keys[0]] for c_ in LI_RESIDENT])
    single = [read(sa).filter(col("l_orderkey") == int(k)).select(*LI_RESIDENT).collect()
              for k in keys]
    router = fabric.make_router({"a": sa, "b": sb}, serve_config=serve_conf)
    try:
        def distinct():
            tickets = [router.submit(lookup(k)) for k in keys]
            router.start()
            got = [t_.result(timeout=600) for t_ in tickets]
            return got, {h: s.stats()["batch_size_hist"] for h, s in router.hosts.items()}

        (b1, hists), rec = step("F4 B1 64 distinct lookups", distinct)
    finally:
        router.close()
    for k, r, s_r in zip(keys, b1, single):
        want = [L[c_][ok == k] for c_ in LI_RESIDENT]
        _check("fabric F4 B1", r, LI_RESIDENT, want)
        _check("fabric F4 B1 single", s_r, LI_RESIDENT, want)
    c = rec["counters"]
    if (rec["launches"].get(tk.K1B, 0) != 2 * one or c.get("serve.batch.dispatches") != 2
            or c.get("serve.batch.queries") != 128 or any(h != {64: 1} for h in hists.values())):
        raise AssertionError(f"fabric F4 B1: {rec}, batch sizes {hists}")
    rec["batch_size_hist"] = hists

    # F5: chaos
    def factories():
        return {"a": lambda: QueryServer(sa, ServeConfig(max_workers=2)),
                "b": lambda: QueryServer(sb, ServeConfig(max_workers=2))}

    retry = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.1)
    hosts = FaultPlan([HostFault("crash", "b", at_query=2)]).wrap(factories())
    # no probation within the run (the dead host is never probed, so lost
    # once) and no hedges
    router = QueryRouter(hosts, health_policy=HealthPolicy(probation_cooldown_s=3600.0),
                         retry_policy=retry, hedging=False).start()
    try:
        crash, rec = step("F5 crash", lambda: [routed(router, a3_build)[0]
                                               for _ in range(FABRIC_CHAOS_QUERIES)])
        rec["health"] = router.stats()["health"]
    finally:
        router.close()
    for r in crash:
        _same_groups("fabric F5 crash", r, f2)
    c = rec["counters"]
    if c.get("router.host_lost") != 1 or c.get("serve.chaos.crashed") != 1:
        raise AssertionError(f"fabric F5 crash: {rec}")

    slow_clock = _Clock()  # never moves: the slow leg is withheld until cancelled
    hosts = {"a": factories()["a"](),
             "b": ChaosHostProxy("b", factories()["b"],
                                 [HostFault("slow", "b", at_query=3, delay_s=1e9, times=1)],
                                 clock=slow_clock)}
    router = QueryRouter(hosts, health_policy=HealthPolicy(
        hedge_min_samples=2, hedge_min_delay_s=0.5, hedge_max_delay_s=0.5),
        retry_policy=retry).start()
    try:
        slow, rec = step("F5 slow host hedged", lambda: [routed(router, a3_build)[0]
                                                         for _ in range(5)])
    finally:
        router.close()
    for r in slow:
        _same_groups("fabric F5 slow", r, f2)
    c = rec["counters"]
    if c.get("router.hedge.issued", 0) < 1 or c.get("router.hedge.won", 0) < 1:
        raise AssertionError(f"fabric F5 slow: {rec}")

    clock = _Clock()
    hosts = {"a": factories()["a"](),
             "b": ChaosHostProxy("b", factories()["b"],
                                 [HostFault("flap", "b", at_query=1, duration_s=0.2),
                                  HostFault("flap", "b", at_query=4, duration_s=0.2)],
                                 clock=clock)}
    # no hedges: a hedged leg on b would move b's submission count, the
    # flap schedule's clock
    router = QueryRouter(hosts, health_policy=HealthPolicy(probation_cooldown_s=0.05),
                         retry_policy=retry, hedging=False)
    router.health = HealthDirector(list(hosts), policy=router.health.policy, clock=clock)
    router.start()
    try:
        def flap():
            got = []
            for _ in range(FABRIC_FLAP_QUERIES):
                got += routed(router, a3_build)
                clock.t += 0.06
            readmitted = metrics.get("router.health.readmitted")
            router.revive_host("b", QueryServer(sb, ServeConfig(max_workers=2)))
            got += routed(router, a3_build)
            return got, readmitted, router.health.state("b"), router.stats()["health"]["b"]

        (flapped, readmitted, state, health_b), rec = step("F5 flap and revive", flap)
    finally:
        router.close()
    for r in flapped:
        _same_groups("fabric F5 flap", r, f2)
    c = rec["counters"]
    rec["health_b"] = health_b
    if (readmitted < 1 or health_b["deaths"] < 2 or state != "healthy"
            or c.get("router.health.readmitted") != readmitted + 1
            or c.get("router.health.revive_offered") != 1):
        raise AssertionError(f"fabric F5 flap: {rec}, readmitted before revive {readmitted}, "
                             f"b {state}")

    # F6: the fleet result cache and warm-compile hints
    ca = host_session(**{"hyperspace.compile.resultCache": "on"})
    cb = host_session(**{"hyperspace.compile.resultCache": "on"})
    router = fabric.make_router({"a": ca, "b": cb}, serve_config=ServeConfig(max_workers=2))
    router.start()
    try:
        routed(router, a3_build)  # cold: declined
        routed(router, a3_build)  # a repeat: admitted
        (hit,), rec = step("F6 fleet cache hit", lambda: routed(router, a3_build))
        pipeline_cache.reset()  # a cold host: its compiled pipelines gone
        hints, hrec = step("F6 warm hints", lambda: router.offer_warm_hints("b"))
    finally:
        router.close()
    _same_groups("fabric F6 hit", hit, f2)
    c = rec["counters"]
    if (c.get("router.result_cache.hit") != 1 or c.get("router.subqueries", 0) != 0
            or sum(rec["launches"].values()) != 0):
        raise AssertionError(f"fabric F6 hit: {rec}")
    hrec["offer"] = hints
    if hints["adopted"] < 1:
        raise AssertionError(f"fabric F6 warm hints: {hints}")

    out["launches"] = {kname: sum(r["launches"].get(kname, 0) for r in out["steps"].values())
                       for kname in (tk.K1, tk.K1C, tk.K1B)}
    out["phase_s"] = time.perf_counter() - t_phase
    log("fabric: " + json.dumps(out))
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
        if tier != "resident":
            rec["burst"] = ladder_burst(session, li, L, table, label, seed, on_card)
    out["launches_k1b"] = sum(t["burst"]["launches"].get("predicate_block_counts_batch", 0)
                              for t in out["tiers"].values() if "burst" in t)
    hbm_cache.reset()
    session.conf.set("hyperspace.torch.hbm.budgetMB", 4096)
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    return out


def ladder_burst(session, li, L: dict, table, label: str, seed: int, on_card: bool,
                 n: int = 16) -> dict:
    """A burst of ``n`` range filters (order key, the packed l_quantity,
    ship date) through a paused server on a compressed or streaming li_st:
    one K1b launch over the packed planes on the compressed tier, one a
    window on the streaming tier; every ticket against numpy."""
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops.kernels import K1B, K1C, K1P
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.serve import QueryServer, ServeConfig
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    ok = L["l_orderkey"]
    top = int(ok.max())
    r = np.random.default_rng(seed + 60)
    items = []
    for _ in range(n):
        lo = int(r.integers(1, top - top // 3))
        q = int(r.integers(5, 50))
        d_lo = DAY_1995_03_15 - 365
        items.append((
            li.filter((col("l_orderkey") >= lo) & (col("l_orderkey") < lo + top // 3)
                      & (col("l_quantity") < q) & (col("l_shipdate") >= d_lo)
                      & (col("l_shipdate") < DAY_1995_03_15)).select(*LI_RESIDENT),
            (ok >= lo) & (ok < lo + top // 3) & (L["l_quantity"] < q)
            & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15)))
    reset_launch_counts()
    metrics.reset()
    server = QueryServer(session, ServeConfig(max_workers=4, autostart=False))
    t = time.perf_counter()
    tickets = [server.submit(df) for df, _m in items]
    server.start()
    got = [x.result(timeout=600) for x in tickets]
    fence(session.device)
    wall = time.perf_counter() - t
    launches, m = launch_counts(), metrics.snapshot()
    stats = server.stats()
    server.close()
    for i, (res, (_df, mask)) in enumerate(zip(got, items)):
        _check(f"ladder {label} burst [{i}]", res, LI_RESIDENT, [L[c][mask] for c in LI_RESIDENT])
    per = table.n_windows if table.tier == "streaming" else 1
    if launches.get(K1B, 0) != (per if on_card else 0) or launches.get(K1C, 0) or \
            launches.get(K1P, 0) or stats["batch_size_hist"] != {n: 1} or \
            m.get("serve.batch.dispatches") != 1:
        raise AssertionError(f"ladder {label} burst: launches {launches}, hist "
                             f"{stats['batch_size_hist']}, counters {m}")
    rec = {"queries": n, "wall_s": wall, "qps": n / wall, "launches": launches,
           "batch_size_hist": stats["batch_size_hist"],
           "latency_p50_ms": stats.get("latency_p50_ms"),
           "latency_p99_ms": stats.get("latency_p99_ms"),
           "batch_device_s": metrics.timings().get("serve.batch.device", (0.0, 0))[0]}
    log(f"ladder {label} burst ({table.tier}): {n} range filters in {wall:.4f} s "
        f"({rec['qps']:.1f} queries/s) | batch_size_hist={rec['batch_size_hist']} launches "
        f"{launches} ({per} a batch) | serve.batch.device {rec['batch_device_s']:.4f} s | "
        f"every ticket matches numpy")
    return rec


def streaming_tables(seed: int, scale: float = 1.0):
    """The streaming phase's TPC-H SF3 lineitem and orders (``scale`` of
    them), from the seed alone."""
    n_l = int(round(SF1_LINEITEM * STREAM_SF * scale))
    n_o = int(round(SF1_ORDERS * STREAM_SF * scale))
    return make_tables(seed + 8, n_o, n_l, n_parts=200_000 * STREAM_SF)


def write_streaming_sources(workdir: Path, seed: int, scale: float = 1.0) -> None:
    """S0's sources: ``src/lineitem_st`` (24 avro files) and
    ``src/orders_st`` (6) under ``workdir``."""
    L, O = streaming_tables(seed, scale)
    write_avro_dir(workdir / "src" / "lineitem_st", L, LINEITEM_SCHEMA, 24)
    write_avro_dir(workdir / "src" / "orders_st", O, ORDERS_SCHEMA, 6)


def start_streaming_sources(workdir: Path, seed: int, scale: float) -> subprocess.Popen:
    """``write_streaming_sources`` in a process of its own (``chip_smoke.py
    --write-streaming-sources DIR SEED SCALE``), started before the kernel
    phase so the write overlaps the phases before the streaming one."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--write-streaming-sources", str(workdir), str(seed), str(scale)])


def streaming_phase(workdir: Path, device: str, seed: int, profile: bool = False,
                    scale: float = 1.0, chunk_rows=None, threshold=None,
                    ladder_budgets=LADDER_BUDGETS_MB, ladder_window_rows=None,
                    sources=None) -> dict:
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
    read; one join arm per Q3, K2 and its fence build once where the arm
    runs K2; at S1 and S4, where both sides are per-bucket files and K2's
    plan declines SF3's flat codes, the native walk, and the C++ gather
    at S1) and equals numpy over the sources as they stand. The native
    runtime's calls are counted over the phase; after S4,
    ``sf3_range_walk`` times its walk over li_runs and ord_st.
    ``chunk_rows`` and ``threshold`` are for rehearsals off the card at a
    small ``scale`` only. ``sources``: the process ``start_streaming_sources``
    started to write S0's sources (waited for here), or None to write them
    now."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.ops.kernels import K1, K1C, K2, K2F
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.storage import layout
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch
    from hyperspace_tpu_torch.telemetry.metrics import build_pipeline_snapshot, metrics

    on_card = device == "cuda"
    native.reset_call_counts()
    t_phase = time.perf_counter()
    L, O = streaming_tables(seed, scale)
    n_l, n_o = len(L["l_orderkey"]), len(O["o_orderkey"])
    t0 = time.perf_counter()
    if sources is None:
        write_streaming_sources(workdir, seed, scale)
        how = "written in"
    else:
        if sources.wait(timeout=1200) != 0:
            raise AssertionError(f"streaming S0: the source writer exited {sources.returncode}")
        how = "written in the background, waited"
    li_dir, od_dir = workdir / "src" / "lineitem_st", workdir / "src" / "orders_st"
    thr = STREAM_THRESHOLD if threshold is None else int(threshold)
    li_bytes = sum(f.stat().st_size for f in li_dir.glob("*.avro"))
    od_bytes = sum(f.stat().st_size for f in od_dir.glob("*.avro"))
    out = {"lineitem_rows": n_l, "orders_rows": n_o, "lineitem_bytes": li_bytes,
           "orders_bytes": od_bytes, "threshold_bytes": thr,
           "write_s": time.perf_counter() - t0, "steps": []}
    log(f"streaming S0: TPC-H SF{STREAM_SF}" + (f" x {scale}" if scale != 1.0 else "")
        + f": lineitem {n_l} rows in 24 avro files, {li_bytes} bytes "
        f"({li_bytes / n_l:.2f} a row); orders {n_o} rows in 6 files, {od_bytes} bytes; "
        f"threshold {thr} bytes; {how} {out['write_s']:.3f} s")
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

    truths = {}  # numpy's answers, by the batches present (steps share them)

    def truth():
        key = tuple(present)
        if key not in truths:
            Lp = {c: np.concatenate([p[0][c] for p in present.values()]) for c in L}
            Op = {c: np.concatenate([p[1][c] for p in present.values()]) for c in O}
            truths[key] = range_and_q3_truth(Lp, Op, bounds, "streaming")
        return truths[key]

    def measure(step, index, verb_s, extra="", want_arms=None):
        """The range filter and Q3, launch counts from zero, against numpy;
        ``want_arms``: the join's arms Q3 must count, where they are fixed."""
        want_r, want_q3 = truth()
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
        # one arm of the join's ladder, and K2 where that arm runs it: at
        # SF3 the presorted route's flat codes (200 buckets x 18M keys)
        # pass int32, K2's plan declines, and the host searches them
        arms = join_arms(m3)
        want_k2 = k2_of_arms(arms, on_card)
        if (l3.get(K2, 0), l3.get(K2F, 0)) != (want_k2, want_k2) or sum(arms.values()) != 1 \
                or (want_arms is not None and {**arms, **expand_arms(m3)} != want_arms):
            raise AssertionError(f"streaming {step}: Q3 launches {l3}, paths {m3}")
        n_files = len(files(index))
        n_runs = sum(layout.is_run_file(f) for f in files(index))
        row = {"step": step, "verb_s": verb_s, "files": n_files, "run_files": n_runs,
               "range_s": t_r, "range_rows": res.num_rows, "range_files_read": read,
               "range_launches": launches, "range_sweeps": m.get("io.segment.sweeps", 0),
               "q3_s": t_q3, "q3_rows": res3.num_rows, "q3_launches": l3, "q3_join_arms": arms,
               "q3_expand_arms": expand_arms(m3),
               "q3_sweeps": m3.get("io.segment.sweeps", 0),
               "q3_segments": m3.get("io.segment.ranges", 0) + m3.get("io.segment.coalesced", 0)}
        out["steps"].append(row)
        log(f"streaming {step}: {verb_s:.3f} s | {index} files={n_files} (run files {n_runs}) | "
            f"range filter {t_r:.4f} s rows={res.num_rows} files read={read} "
            f"segment sweeps={row['range_sweeps']} launches={launches} | Q3 {t_q3:.4f} s "
            f"rows={res3.num_rows} segment sweeps={row['q3_sweeps']} segments="
            f"{row['q3_segments']} launches={l3} join arms={list(arms)} expand="
            f"{list(expand_arms(m3))}{extra} | matches numpy")
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
    out["li_st"]["pipeline"] = build_pipeline_snapshot()
    log(f"streaming S1 build_pipeline_snapshot: {json.dumps(out['li_st']['pipeline'])}")
    metrics.reset()
    t = verb(hsp.create_index, session.read.avro(str(od_dir)), hs.IndexConfig(
        "ord_st", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_totalprice"]))
    if metrics.get("build.stream.rows") or metrics.get("build.engine.device") != 1:
        raise AssertionError("streaming S1: ord_st did not build in memory")
    out["ord_st_build_s"] = t
    log(f"streaming S1 build ord_st (under the threshold: in memory): {t:.3f} s")
    out["staged_programs"] = staged_programs(L, cap, STREAM_RUN_CHUNKS, device)
    session.enable_hyperspace()
    # per-bucket files on both sides, K2's plan declining SF3's flat codes
    # (200 buckets x 18M keys pass int32): the native walk, then the C++
    # gather; at a rehearsal's cut scale K2 accepts them
    native_arms = ({"join.path.native_smj_ranges": 1, "join.path.native_smj_gather": 1}
                   if scale == 1.0 else None)
    measure("S1 li_st", "li_st", build_s, want_arms=native_arms)
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
    _check("streaming S2 resident range filter", res, R_COLS, truth()[0])
    if m.get("scan.path.resident_device", 0) != 1 or launches.get(K1C, 0) != (
            1 if on_card else 0) or launches.get(K1, 0):
        raise AssertionError(f"streaming S2 resident: launches {launches}, counters {m}")
    out["resident"] = {"prefetch_s": t_pre, "s": t_res, "rows": res.num_rows, "launches": launches}
    log(f"streaming S2 resident: prefetch_index(li_runs) {t_pre:.3f} s | range filter "
        f"{t_res:.4f} s rows={res.num_rows} launches={launches} | matches numpy")

    # S3: one RF1 batch appended and refreshed, then RF2 through the lineage rewrite
    n_new = max(1, int(round(1500 * n_o / SF1_ORDERS)))
    li_new, od_new = rf1_batches(O, seed + 8, n_new, n_batches=1,
                                 n_parts=200_000 * STREAM_SF)[0]
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
            f" | {len(step_s)} steps, files {before} -> {len(after)}", want_arms=native_arms)
    out["native_calls"] = native.call_counts()
    log(f"streaming: native calls {out['native_calls']}")
    if on_card and scale == 1.0 and out["native_calls"].get("hs_smj_ranges", 0) < 2:
        raise AssertionError(f"streaming: S1 and S4 did not walk natively: {out['native_calls']}")
    out["native_walk"] = sf3_range_walk(files("li_runs"), files("ord_st"), device)
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
    if want & {"aggregate", "resident", "join", "serve", "native", "front_end", "fabric"}:
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
                    + " (default: all; aggregate, resident, join, serve, native, front_end "
                    "and fabric bring main)")
    ap.add_argument("--write-streaming-sources", nargs=3, metavar=("DIR", "SEED", "SCALE"),
                    help="write the streaming phase's sources under DIR (the run starts it)")
    ap.add_argument("--fabric-worker", nargs=4, metavar=("PID", "NPROC", "DIR", "DEVICE"),
                    help="run one worker process of the fabric phase's multi-process build "
                    "(the fabric phase starts them)")
    args = ap.parse_args()
    phases = args.phases
    if args.fabric_worker:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return fabric_worker(*args.fabric_worker)
    if args.write_streaming_sources:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        wdir, wseed, wscale = args.write_streaming_sources
        write_streaming_sources(Path(wdir), int(wseed), float(wscale))
        return 0

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
    from concurrent.futures import ThreadPoolExecutor

    from hyperspace_tpu_torch import native

    # g++ builds the native runtime while nvcc builds the kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        g_build = pool.submit(lambda: (native.available(), time.perf_counter() - t0)[1])
        tk.build_kernels()
        log(f"setup: kernels built and loaded in {time.perf_counter() - t0:.3f} s")
        log(f"setup: the native runtime ({native._lib_path().name}) built by g++ and loaded in "
            f"{g_build.result():.3f} s | host: {os.cpu_count()} CPUs, {cpu_model()}")
    ptxas = {}
    for kname in (tk.K1, tk.K2):
        ptxas[kname] = ptxas_summary(tk.build_report(kname))
        for fn, info in sorted(ptxas[kname].items()):
            log(f"setup: ptxas {fn}: registers={info.get('registers')} "
                f"static_smem={info.get('static_smem')} "
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

    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="hs_smoke_"))
    workdir.mkdir(parents=True, exist_ok=True)
    # host work that needs only the sources or the seed runs in processes
    # of its own beside the phases before the one that reads it
    lint_dump = workdir / "lint_callgraph.json"
    lint_proc = start_lint(lint_dump) if "lint" in phases else None
    sources = (start_streaming_sources(workdir / "streaming", args.seed, args.scale)
               if "streaming" in phases else None)
    stream_out = None
    try:
        t0 = time.perf_counter()
        kphase = kernel_phase(lineitem, orders, args.seed) if "kernels" in phases else None
        log(f"phase seconds: kernels {time.perf_counter() - t0:.1f} s")
        # launches above compared kernels with their plain versions; each
        # path's counts start from zero inside its phase
        main_out = run_main_path(lineitem, orders, workdir, "cuda", args.seed, args.profile,
                                 phases)
        if "streaming" in phases:
            cut = {}
            if args.scale != 1.0:  # a cut: the threshold and chunks shrink with the tables
                cut = {"chunk_rows": max(1024, int((1 << 21) * args.scale)),
                       "threshold": int(STREAM_THRESHOLD * args.scale)}
                log(f"CUT: streaming phase at scale {args.scale}: {cut}")
            stream_out = streaming_phase(workdir / "streaming", "cuda", args.seed, args.profile,
                                         scale=args.scale, sources=sources, **cut)
            log(f"phase seconds: streaming {stream_out['phase_s']:.1f} s")
            degrade_guard("streaming")
        lint_out = None
        if "lint" in phases:
            t0 = time.perf_counter()
            lint_out = lint_phase(lint_proc, lint_dump)
            log(f"phase seconds: lint {time.perf_counter() - t0:.1f} s")
    finally:
        for proc in (lint_proc, sources):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    # each kernel's launches on its paths (None where no phase of them ran)
    launches = {k: None for k in (tk.K1, tk.K1C, tk.K1P, tk.K1H, tk.K1B, tk.K1HB, tk.K2, tk.K2F,
                                  tk.K2P)}
    if "launches" in main_out:
        for kname in (tk.K1, tk.K2, tk.K2F):
            launches[kname] = main_out["launches"].get(kname, 0)
    if "resident" in main_out:
        launches[tk.K1C] = main_out["resident"]["launches"].get(tk.K1C, 0)
    if "join" in main_out:
        # K2p on the join phase's warm resident calls (forDelta on)
        launches[tk.K2P] = main_out["join"]["launches_k2p"]
    if stream_out is not None:
        # K1p on the ladder's compressed and streaming tiers
        launches[tk.K1P] = sum(t["launches"].get(tk.K1P, 0)
                               for t in stream_out["ladder"]["tiers"].values())
    if "hybrid" in main_out:
        # K1h on the hybrid phase's resident-hybrid queries, K1hb on its burst
        launches[tk.K1H] = sum(main_out["hybrid"][s]["launches"].get(tk.K1H, 0)
                               for s in ("h2_delta", "h3_delta"))
        launches[tk.K1HB] = main_out["hybrid"]["h2_burst"]["launches"].get(tk.K1HB, 0)
    if "serve" in main_out or stream_out is not None:
        # K1b on the serve phase's bursts and the ladder's compressed and
        # streaming bursts
        launches[tk.K1B] = main_out.get("serve", {}).get("launches_k1b", 0) + (
            0 if stream_out is None else stream_out["ladder"]["launches_k1b"])
    if "reliability" in main_out:
        # K1 (R1's range filter, R5's per-file lookups), K2 and K2F (R1's
        # Q3), K1b (R5's fresh server)
        for kname, n in main_out["reliability"]["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    if "mesh" in main_out:
        # K1 (M2's range filter, M4's aggregate, M6's sides, MR4's device
        # aggregate and MR8's per-query route: one a shard), K2 and K2F (M3
        # and M5 one a shard, M6's exact join once, MR5's first call), K1c,
        # K1p, K1b, K1h and K2p (MR2-MR7: one a shard, a window for MR3's
        # streaming tier)
        for kname, n in main_out["mesh"]["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    if "fabric" in main_out:
        # K1 (F2 and F5's queries: one a host leg), K1c (F3, and F4's
        # identical lookup: one a host leg), K1b (F4's B1 burst: one a host)
        for kname, n in main_out["fabric"]["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    for kname, n in launches.items():
        if n is not None and n <= 0:
            raise AssertionError(f"{kname} was not launched on its path ({launches})")

    details = {}
    if "launches" in main_out:
        details["main_path"] = {k: main_out[k] for k in ("build_s", "query_s", "rows")}
    for key, name in (("aggregate", "aggregate"), ("resident", "resident_path"),
                      ("join", "join"), ("serve", "serve"), ("native", "native"),
                      ("front_end", "front_end"),
                      ("lifecycle", "lifecycle"), ("hybrid", "hybrid"),
                      ("reliability", "reliability"), ("mesh", "mesh"),
                      ("fabric", "fabric")):
        if key in main_out:
            details[name] = main_out[key]
    log(json.dumps({**details, "streaming": stream_out, "lint": lint_out,
                    "kernel_cases": kphase, "ptxas": ptxas,
                    "phases": list(phases), "total_s": time.perf_counter() - t_start}))
    log("native: " + json.dumps(native_line(main_out, stream_out)))
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
    k2p = kphase["k2p"]["region_layout"]
    k1b = kphase["k1b"]["B1_point_N64"]
    k1hb = kphase["k1hb"]["li_hy_N16"]
    mask_src = "hyperspace_tpu_torch/csrc/predicate_mask.cu"
    join_src = "hyperspace_tpu_torch/csrc/sorted_intersect.cu"
    rows = (
        (tk.K1, mask_src, "hyperspace_tpu/ops/kernels.py:237", "k1", k1),
        (tk.K1C, mask_src, "hyperspace_tpu/exec/hbm_cache.py:476", "k1c", k1c),
        (tk.K1P, mask_src, "hyperspace_tpu/exec/hbm_cache.py:447", "k1p", k1p),
        (tk.K1H, mask_src, "hyperspace_tpu/exec/hbm_cache.py:671", "k1h", k1h),
        (tk.K1B, mask_src, "hyperspace_tpu/exec/hbm_cache.py:617", "k1b", k1b),
        (tk.K1HB, mask_src, "hyperspace_tpu/exec/hbm_cache.py:728", "k1hb", k1hb),
        (tk.K2, join_src, "hyperspace_tpu/ops/kernels.py:549", "k2", k2),
        (tk.K2F, join_src, "hyperspace_tpu/ops/kernels.py:549", "k2f", k2f),
        (tk.K2P, join_src, "hyperspace_tpu/exec/join_residency.py:952", "k2p", k2p),
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
