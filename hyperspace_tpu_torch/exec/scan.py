"""The physical scan over TCB index data.

Counterpart of ``hyperspace_tpu.exec.scan`` (its host leg). Pipeline per
query:

  1. hash-bucket pruning — an equality predicate that pins every indexed
     column touches only its buckets' files;
  2. footer min/max zone-map pruning against the predicate's bounds
     (storage.layout.prune_by_min_max) — files whose range can't match are
     never opened;
  3. mmap the surviving column buffers (no decode — TCB is raw columns);
  4. the predicate mask on the device: the CUDA mask kernel
     (ops.kernels.predicate_mask) when the predicate and data narrow to
     int32, torch ops otherwise; predicates touching float64 evaluate on
     the host, exactly, as in the reference;
  5. row compaction.

When the index version's predicate columns are resident on the device
(exec.hbm_cache), steps 3-5 give way to the resident protocol: one K1c
launch (K1p over packed planes, one launch a window on the streaming
tier) counts matches per 8192-row block over the whole table, and the
host reads, re-evaluates exactly and gathers only the blocks that hold
matches (``_resident_parts``). A zone-map gate routes predicates that
cannot prune blocks to the per-file path first; a miss schedules the
table's background upload when the session's residency mode allows.

Multi-bucket run files (the streaming build's finalizeMode=runs) are read
whole, or, under an equality predicate that pins buckets, at those buckets'
row ranges through the coalesced segment planner. The measured scan gate
of the reference is not ported.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from ..config import ResidencyConf
from ..exceptions import HyperspaceException
from ..ops import DeviceLike, resolve_device
from ..ops.hashing import bucket_of_values
from ..plan.expr import Expr, bind_string_literals, bounds_for_column, eval_mask, pinned_values
from ..storage import layout
from ..storage.columnar import Column, ColumnarBatch
from ..telemetry.metrics import metrics


def buckets_for_predicate(
    predicate: Expr,
    indexed_columns: List[str],
    dtypes: dict,
    num_buckets: int,
    max_product: int = 64,
):
    """The set of buckets an equality predicate can touch, or None for all.

    Valid only when the predicate pins *every* indexed column to a finite
    value set (the hash covers all indexed columns) — the analog of Spark's
    bucket pruning over the index's BucketSpec."""
    per_col = []
    total = 1
    for c in indexed_columns:
        vals = pinned_values(predicate, c)
        if vals is None:
            return None
        per_col.append(sorted(vals, key=repr))
        total *= len(vals)
        if total > max_product:
            return None
    buckets = set()
    for combo in itertools.product(*per_col):
        buckets.add(
            bucket_of_values(combo, [dtypes[c] for c in indexed_columns], num_buckets)
        )
    return buckets


def device_mask(
    predicate: Expr, batch: ColumnarBatch, device: DeviceLike = None
) -> np.ndarray:
    """The predicate's row mask over ``batch``, evaluated on ``device``."""
    names = sorted(predicate.columns())
    # float64 never takes the device arms (the reference keeps it on the
    # host, exactly) — predicates touching f64 evaluate on host
    if any(batch.columns[n_].dtype_str == "float64" for n_ in names):
        metrics.incr("scan.path.host_f64")
        return np.asarray(eval_mask(predicate, batch))
    n = batch.num_rows
    # string literals bind to this batch's dictionary codes, so the bound
    # expression is pure int arithmetic (shared by both device arms)
    bound = bind_string_literals(predicate, batch)
    mask = _mask_kernel(bound, batch, names, n, device)
    if mask is not None:
        metrics.incr("scan.path.kernel_mask")
        return mask
    # not int32-narrowable: the same predicate in torch ops on the device
    metrics.incr("scan.path.torch_mask")
    dev = resolve_device(device)
    shim = ColumnarBatch(
        {
            name: Column("int32", np.empty(0, dtype=np.int32))
            if batch.columns[name].vocab is not None
            else Column(
                batch.columns[name].dtype_str,
                np.empty(0, dtype=batch.columns[name].data.dtype),
            )
            for name in names
        }
    )
    arrays = batch.select(names).device_arrays(device=dev)
    return eval_mask(bound, shim, arrays).cpu().numpy()


def _mask_kernel(bound, batch, names, n, device):
    from ..ops import kernels

    return kernels.predicate_mask(
        bound, {name: batch.columns[name].data for name in names}, n, device
    )


def _resident_parts(
    table,
    files: List[Path],
    output_columns: List[str],
    predicate: Expr,
    counts: np.ndarray,
    path_metric: Optional[str] = "scan.path.resident_device",
) -> List[ColumnarBatch]:
    """The result batches of a resident scan: the host reads ONLY the
    8192-row blocks the device counted matches in (pad rows past a file's
    end are never read), re-evaluates the predicate exactly there, and
    gathers the output columns from mmap. Parts come back in ``files``
    order, the per-file path's output order. ``path_metric`` names the
    tier that served (None: the hybrid path counts its own)."""
    from .hbm_cache import BLOCK_ROWS

    candid = np.flatnonzero(counts)
    if path_metric is not None:
        metrics.incr(path_metric)
    metrics.incr("scan.resident.blocks_touched", int(len(candid)))
    metrics.incr("scan.resident.blocks_total", int(len(counts)))
    if candid.size == 0:
        return []
    need = list(dict.fromkeys(list(output_columns) + sorted(predicate.columns())))
    parts: List[ColumnarBatch] = []
    for f in files:
        span = table.file_span(str(f))
        if span is None:  # cannot happen (resident_for covered the files)
            continue
        start, end = span
        b_lo, b_hi = start // BLOCK_ROWS, -(-end // BLOCK_ROWS)
        mine = candid[(candid >= b_lo) & (candid < b_hi)]
        if mine.size == 0:
            continue
        # merge adjacent candidate blocks into contiguous row runs
        runs: List[List[int]] = []
        for b in mine:
            lo = max(int(b) * BLOCK_ROWS, start) - start
            hi = min((int(b) + 1) * BLOCK_ROWS, end) - start
            if runs and runs[-1][1] == lo:
                runs[-1][1] = hi
            else:
                runs.append([lo, hi])
        reader = layout.cached_reader(f)
        for lo, hi in runs:
            batch = reader.read(need, row_range=(lo, hi))
            idx = np.flatnonzero(eval_mask(predicate, batch))
            if idx.size:
                parts.append(batch.take(idx).select(output_columns))
    return parts


def _resident_scan(
    all_files: List[Path],
    files: List[Path],
    output_columns: List[str],
    predicate: Expr,
    device: DeviceLike,
    residency: ResidencyConf,
) -> Optional[List[ColumnarBatch]]:
    """The resident arm of ``index_scan``: its result parts, or None when
    the query takes the per-file path (no covering table, the zone gate
    routed host, or the predicate does not narrow to the resident
    encodings). A miss schedules first-touch population over the index
    version's FULL file list, so one table serves every later subset."""
    from .hbm_cache import hbm_cache, zone_block_fraction

    pred_cols = sorted(predicate.columns())
    table = hbm_cache.resident_for(files, pred_cols, device, residency)
    if table is None:
        if hbm_cache.auto_enabled(residency, device):
            hbm_cache.note_touch(all_files, pred_cols, device, residency)
        return None
    # selectivity gate: the zone vectors bound the block fraction the
    # predicate can touch; when the host would read nearly every block
    # anyway, the device pass is pure overhead — route host before it
    frac = zone_block_fraction(table, predicate)
    if frac is not None:
        # per-mille sum + eval count: mean fraction = sum / count
        metrics.incr("scan.gate.resident_zone_frac_pm", int(frac * 1000))
        metrics.incr("scan.gate.resident_zone_evals")
        if residency.max_block_frac < 1.0 and frac >= residency.max_block_frac:
            metrics.incr("scan.gate.resident_selectivity")
            return None
    counts = hbm_cache.block_counts(table, predicate)
    if counts is None:
        metrics.incr("scan.resident.declined")
        return None
    # the path metric names the tier that served: raw planes, packed
    # planes (K1p), or the window loop
    return _resident_parts(table, files, output_columns, predicate, counts,
                           path_metric=_TIER_PATH_METRIC[table.tier])


_TIER_PATH_METRIC = {
    "resident": "scan.path.resident_device",
    "compressed": "scan.path.resident_compressed",
    "streaming": "scan.path.resident_streaming",
}


def empty_batch_for(output_columns, dtypes) -> Optional[ColumnarBatch]:
    """A 0-row batch projecting ``output_columns`` out of a (possibly
    differently-cased) ``dtypes`` schema, or None when the schema can't
    cover the projection."""
    if not dtypes:
        return None
    resolved = {k.lower(): v for k, v in dtypes.items()}
    if any(c.lower() not in resolved for c in output_columns):
        return None
    return ColumnarBatch.empty({c: resolved[c.lower()] for c in output_columns})


def prune_index_files(
    files: List[Path],
    predicate: Optional[Expr],
    indexed_columns: Optional[List[str]] = None,
    dtypes: Optional[dict] = None,
    num_buckets: Optional[int] = None,
    pinned_buckets: Optional[set] = None,
) -> List[Path]:
    """Hash-bucket pruning (equality predicates pin buckets) followed by
    footer zone-map pruning; no file is opened for data. Multi-bucket RUN
    files survive bucket pruning whole: their pinned buckets become
    row-range reads in the scan itself."""
    if predicate is None:
        return files
    if pinned_buckets is None and indexed_columns and dtypes and num_buckets:
        pinned_buckets = buckets_for_predicate(
            predicate, indexed_columns, dtypes, num_buckets
        )
    if pinned_buckets is not None:
        files = [
            f
            for f in files
            if layout.is_run_file(f) or layout.bucket_of_file(f) in pinned_buckets
        ]
    for c in sorted(predicate.columns()):
        lo, hi = bounds_for_column(predicate, c)
        if lo is not None or hi is not None:
            files = layout.prune_by_min_max(files, c, lo, hi)
    return files


def index_scan(
    data_files: Iterable[str | Path],
    output_columns: List[str],
    predicate: Optional[Expr] = None,
    device: DeviceLike = None,
    indexed_columns: Optional[List[str]] = None,
    dtypes: Optional[dict] = None,
    num_buckets: Optional[int] = None,
    residency: ResidencyConf = ResidencyConf(),
) -> ColumnarBatch:
    """Scan index data files, returning the filtered projection in file
    order. When ``indexed_columns``/``dtypes``/``num_buckets`` describe the
    index's bucketing, equality predicates prune to their hash buckets
    before any file is opened. ``residency`` is the session's HBM
    residency policy (exec.hbm_cache)."""
    all_files = [Path(p) for p in data_files]
    pinned = None
    if predicate is not None and indexed_columns and dtypes and num_buckets:
        pinned = buckets_for_predicate(predicate, indexed_columns, dtypes, num_buckets)
    files = prune_index_files(
        all_files,
        predicate,
        indexed_columns,
        dtypes,
        num_buckets,
        pinned_buckets=pinned,
    )
    metrics.incr("scan.files_read", len(files))
    need = (
        list(dict.fromkeys(list(output_columns) + sorted(predicate.columns())))
        if predicate is not None
        else list(output_columns)
    )
    if predicate is not None and files:
        resident = _resident_scan(
            all_files, files, output_columns, predicate, device, residency
        )
        if resident is not None:
            if resident:
                return ColumnarBatch.concat(resident)
            return _empty_result(files, output_columns, dtypes)
    # run files under pinned buckets are read at those buckets' row ranges
    # only (the runs layout's stand-in for file-level bucket pruning)
    special: dict = {}
    if pinned is not None and any(layout.is_run_file(f) for f in files):
        with metrics.timer("scan.run_segment_io"):
            special = _read_run_segments(
                [f for f in files if layout.is_run_file(f)], need, pinned
            )
    bulk_files = [f for f in files if f not in special]
    bmap = dict(zip(bulk_files, layout.read_batches(bulk_files, columns=need)))
    bmap.update(special)
    parts: List[ColumnarBatch] = []
    for f in files:
        batch = bmap[f]
        if batch is None or batch.num_rows == 0:
            continue
        if predicate is not None:
            idx = np.flatnonzero(device_mask(predicate, batch, device))
            if idx.size == 0:
                continue
            batch = batch.take(idx)
        parts.append(batch.select(output_columns))
    if not parts:
        return _empty_result(files, output_columns, dtypes)
    return ColumnarBatch.concat(parts)


def _read_run_segments(run_files: List[Path], need: List[str], pinned: set) -> dict:
    """The pinned buckets' row ranges of every run file, read through the
    coalesced segment planner (one ordered sweep per run file). Returns
    {file: batch, or None when those buckets hold no rows there}. A run
    file without its bucketCounts footer raises."""
    plan = layout.plan_segment_reads(run_files, buckets=set(pinned))
    got = layout.execute_segment_reads(plan, columns=need)
    out: dict = {f: None for f in run_files}
    n_segments = 0
    for sw in plan:
        parts = [got[(sw.path, b)] for b, _lo, _hi in sw.segments]
        n_segments += len(parts)
        match = next(f for f in run_files if str(f) == sw.path)
        out[match] = parts[0] if len(parts) == 1 else ColumnarBatch.concat(parts)
    if n_segments:
        metrics.incr("scan.run_bucket_segments", n_segments)
    return out


def _empty_result(
    files: List[Path], output_columns: List[str], dtypes: Optional[dict]
) -> ColumnarBatch:
    """Empty result with correct schema: from the index's logged schema
    when available, else from a surviving file's footer."""
    empty = empty_batch_for(output_columns, dtypes)
    if empty is not None:
        return empty
    if not files:
        raise HyperspaceException("index_scan over zero files with no schema.")
    eb = layout.read_batch(files[0], columns=output_columns)
    return eb.take(np.array([], dtype=np.int64))
