"""The per-bucket merge that optimize writes through.

Parity: ``hyperspace_tpu.index.compactor`` — ``merge_bucket_parts``,
``partition_compactable`` and ``compact_bucket_group``, over per-bucket
files. Multi-bucket run files (the reference's streaming build with
finalizeMode=runs) are not written by this package; one reaching these
functions raises "not yet ported", and so do the background compactor
(``CompactionStep``, ``IndexCompactor``), which waits for the streaming
build. The buckets of a group merge in a plain loop: the results are the
reference's, whose merge pool only spreads them across threads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..storage import layout
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics


def _refuse_run_files(paths) -> None:
    if paths:
        raise HyperspaceException(
            "Compacting multi-bucket run files is not yet ported to "
            f"hyperspace_tpu_torch ({len(paths)} run file(s))."
        )


def merge_bucket_parts(
    parts: List[ColumnarBatch], parts_sorted: bool, indexed: List[str]
) -> ColumnarBatch:
    """Merge one bucket's parts into its key order. Parts that all carry
    the right footer sort claim merge by the stable searchsorted
    tournament (stream_builder.merge_sorted_runs); anything else re-sorts
    through the shared order-preserving encodings."""
    from .stream_builder import merge_sorted_runs, sort_encoding

    if parts_sorted:
        return merge_sorted_runs(parts, list(indexed))
    merged = parts[0] if len(parts) == 1 else ColumnarBatch.concat(parts)
    reprs = [sort_encoding(merged.columns[c]) for c in indexed]
    order = np.lexsort(list(reversed(reprs)))
    return merged.take(order)


def partition_compactable(
    file_infos, threshold: int, quick: bool
) -> Tuple[Dict[int, list], list, set, list]:
    """OptimizeAction.scala:115-133's partition rule: (small files by
    bucket, run files, the buckets holding rows in any run, untouched
    files). A bucket with one small file is already compact. The run-file
    lists stay empty here: a run file raises."""
    by_bucket: Dict[int, list] = {}
    _refuse_run_files([fi for fi in file_infos if layout.is_run_file(fi.name)])
    for fi in file_infos:
        by_bucket.setdefault(layout.bucket_of_file(fi.name), []).append(fi)
    to_optimize: Dict[int, list] = {}
    untouched: list = []
    for b, files in by_bucket.items():
        if quick:
            small = [f for f in files if f.size < threshold]
            big = [f for f in files if f.size >= threshold]
        else:
            small, big = list(files), []
        if len(small) < 2:
            untouched.extend(files)
            continue
        to_optimize[b] = small
        untouched.extend(big)
    return to_optimize, [], set(), untouched


def compact_bucket_group(
    buckets: List[int],
    small_by_bucket: Dict[int, List[str]],
    run_paths: List[str],
    version_dir: Path,
    indexed: List[str],
    workers: int,
) -> Dict[int, Optional[str]]:
    """Merge each bucket's small per-bucket files, in log order, into one
    freshly written ``b``-file under ``version_dir``. Returns {bucket: new
    path, or None when the bucket holds no part}. ``workers`` is the
    reference's merge-pool width; the merges here run one after another."""
    _refuse_run_files(run_paths)

    def one(b: int) -> Optional[str]:
        with metrics.timer("compaction.bucket_read"):
            parts: List[ColumnarBatch] = []
            parts_sorted = True
            for f in small_by_bucket.get(b, []):
                parts.append(layout.read_batch(f))
                parts_sorted = parts_sorted and (
                    layout.cached_reader(f).footer.get("sortedBy") == list(indexed)
                )
        if not parts:
            return None
        with metrics.timer("compaction.bucket_sort"):
            merged = merge_bucket_parts(parts, parts_sorted, list(indexed))
        with metrics.timer("compaction.bucket_write"):
            out = version_dir / layout.bucket_file_name(b)
            layout.write_batch(out, merged, sorted_by=list(indexed), bucket=b)
        metrics.incr("compaction.buckets")
        return str(out)

    return {b: one(b) for b in sorted(buckets)}
