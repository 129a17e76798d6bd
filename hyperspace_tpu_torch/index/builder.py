"""The index-build engine: runs the bucketize+sort and writes the bucketed,
sorted TCB layout.

Counterpart of ``hyperspace_tpu.index.builder`` (its single-device arm):
project columns, hash-partition into ``num_buckets``, sort each bucket on
the indexed columns, write one file per non-empty bucket into a version
directory. Execution is ops.build (torch on the device, or the numpy host
engine with ``engine=host``); storage is storage.layout. Sources over the
streaming threshold take index.stream_builder instead (actions/create.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..ops import DeviceLike
from ..storage import layout
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics
from ..utils import resolver


def resolve_index_columns(
    schema_cols: List[str], indexed: List[str], included: List[str]
) -> Tuple[List[str], List[str]]:
    """Case-insensitive resolution of user columns against the source schema
    (CreateActionBase.resolveConfig, CreateActionBase.scala:142-162)."""
    r_indexed = resolver.resolve_all(indexed, schema_cols)
    r_included = resolver.resolve_all(included, schema_cols)
    if r_indexed is None or r_included is None:
        missing = [
            c
            for c in list(indexed) + list(included)
            if resolver.resolve(c, schema_cols) is None
        ]
        raise HyperspaceException(
            f"Columns {missing} could not be resolved against source schema "
            f"{schema_cols}."
        )
    return r_indexed, r_included


def write_index_data(
    batch: ColumnarBatch,
    indexed_cols: List[str],
    num_buckets: int,
    out_dir: str | Path,
    extra_meta: Optional[dict] = None,
    device: DeviceLike = None,
    engine: str = "auto",
    host_workers: int = 1,
) -> List[Path]:
    """Partition+sort ``batch`` and write one TCB file per non-empty bucket
    into ``out_dir``. Returns the written paths, sorted. ``engine``: device
    (the sort on ``device``), host (the numpy twin, its one stable sort
    split over ``host_workers`` threads) or auto, which is the device here:
    the reference sends builds under 2^22 rows to its host twin because a
    one-shot XLA compile costs tens of seconds on a TPU, and torch ops
    compile nothing. File contents are byte-identical to what
    ``hyperspace_tpu`` writes for the same batch (the file names carry a
    random suffix)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if _route_inmemory_engine(engine) == "host":
        from ..ops.build import build_partition_host_parallel

        metrics.incr("build.engine.host")
        sorted_batch, counts = build_partition_host_parallel(
            batch, indexed_cols, num_buckets, host_workers
        )
    else:
        from ..ops.build import build_partition_single

        metrics.incr("build.engine.device")
        sorted_batch, counts = build_partition_single(
            batch, indexed_cols, num_buckets, device=device
        )
    written: List[Path] = []
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for b in range(num_buckets):
        s, e = int(offsets[b]), int(offsets[b + 1])
        if e <= s:
            continue  # empty buckets have no file, as with Spark's bucketed write
        p = out_dir / layout.bucket_file_name(b)
        layout.write_batch(
            p,
            sorted_batch.take(np.arange(s, e)),
            sorted_by=list(indexed_cols),
            bucket=b,
            extra=extra_meta,
        )
        written.append(p)
    return sorted(written)


def _route_inmemory_engine(engine: str) -> str:
    if engine in ("device", "host"):
        return engine
    if engine != "auto":
        raise HyperspaceException(
            f"Unknown build engine {engine!r}; expected device, host, or auto."
        )
    return "device"
